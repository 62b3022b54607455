"""The five RA rule families (port of ``repro.analysis.checkers``). Each
module exposes ``RULES`` (metadata) and either ``check(ctx)`` (per-file)
or, for the registry-driven domain checker, ``check_file(ctx, registry)``
plus ``registries`` (one ``KindRegistry`` a package)."""

from repro_torch.analysis.checkers import (consttime, determinism, domains,
                                     obshooks, tracing)

ALL_RULES = (determinism.RULES + obshooks.RULES + consttime.RULES
             + tracing.RULES + domains.RULES)

__all__ = ["consttime", "determinism", "domains", "obshooks", "tracing",
           "ALL_RULES"]
