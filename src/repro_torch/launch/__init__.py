"""Launchers of the port (counterpart of ``repro.launch``): the PoFEL
trainer's (``python -m repro_torch.launch.train``), the serving
launcher's (``python -m repro_torch.launch.serve``), and the mesh
launchers: ``mesh``, ``specs``, ``costs``, ``roofline``, the
dry run (``python -m repro_torch.launch.dryrun``) and the hillclimb
driver (``python -m repro_torch.launch.hillclimb``); the steps run as
DTensor programs on any mesh (several ranks on the CPU through
``mesh.run_on_ranks``), and their collectives are counted without
moving data (``collectives``) for the roofline's collective term."""
