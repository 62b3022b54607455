"""Client-edge topology: FEL clusters, each headed by one BCFL node
(paper §3, Fig. 2)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.data.partition import (partition_dirichlet, partition_iid,
                                        partition_label_limited)
from repro_torch.fl.client import Client


@dataclass
class FELCluster:
    """One BCFL node (edge server) + its connected clients."""

    node_id: int
    clients: List[Client] = field(default_factory=list)

    @property
    def data_size(self) -> int:
        return sum(c.data_size for c in self.clients)


def build_hierarchy(dataset, n_nodes: int,
                    clients_per_node: int = 5, distribution: str = "iid",
                    labels_per_client: int = 6, dirichlet_alpha: float = 0.5,
                    seed: int = 0) -> List[FELCluster]:
    """Partition `dataset` into n_nodes × clients_per_node client shards.

    distribution: 'iid' | 'label' (paper's non-IID, ~6/10 labels per client)
                  | 'dirichlet'

    ``dataset`` is anything with ``__len__``/``subset`` (images or tokens);
    the label-aware partitions additionally need ``.y``/``.n_classes``.
    """
    n_clients = n_nodes * clients_per_node
    if distribution == "iid":
        shards = partition_iid(dataset, n_clients, seed=seed)
    elif distribution == "label":
        shards = partition_label_limited(dataset, n_clients,
                                         labels_per_part=labels_per_client, seed=seed)
    elif distribution == "dirichlet":
        shards = partition_dirichlet(dataset, n_clients, alpha=dirichlet_alpha,
                                     seed=seed)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")

    clusters = []
    cid = 0
    for nid in range(n_nodes):
        clients = []
        for _ in range(clients_per_node):
            clients.append(Client(cid, shards[cid]))
            cid += 1
        clusters.append(FELCluster(nid, clients))
    return clusters
