"""FEL of the PyTorch port: clients, FedAvg, the hierarchy, the model
adapters, the batched FEL engine and the BHFL runtime."""

from repro_torch.fl.adapters import (EvalResult, LMAdapter, MLPAdapter,
                                     ModelAdapter, make_adapter,
                                     rwkv6_adapter, transformer_adapter)
from repro_torch.fl.batched_fel import (BatchedFELEngine, BatchedTrainSpec,
                                        engine_for)
from repro_torch.fl.client import Client, local_train
from repro_torch.fl.fedavg import fedavg
from repro_torch.fl.hierarchy import FELCluster, build_hierarchy
from repro_torch.fl.hfl_runtime import (AllNodesPlagiarizeError, BHFLConfig,
                                        BHFLRuntime, RoundMetrics)

__all__ = ["Client", "local_train", "fedavg", "FELCluster", "build_hierarchy",
           "BHFLConfig", "BHFLRuntime", "RoundMetrics",
           "AllNodesPlagiarizeError",
           "BatchedFELEngine", "BatchedTrainSpec", "engine_for",
           "ModelAdapter", "MLPAdapter", "LMAdapter", "EvalResult",
           "make_adapter", "transformer_adapter", "rwkv6_adapter"]
