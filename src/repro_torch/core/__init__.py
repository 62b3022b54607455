"""PoFEL core of the PyTorch port: serialization, ME, BTSV, the
Stackelberg incentive, HCDS and its crypto, the five protocol phases and
the consensus driver — the counterparts of ``repro.core``'s modules.
Import them from their modules."""
