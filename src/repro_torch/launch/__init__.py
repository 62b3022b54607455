"""Launchers of the port (counterpart of ``repro.launch``): the PoFEL
trainer's (``python -m repro_torch.launch.train``), the serving
launcher's (``python -m repro_torch.launch.serve``), and the layout half
of the mesh launchers: ``mesh``, ``specs``, ``costs``, ``roofline``, the
dry run (``python -m repro_torch.launch.dryrun``) and the hillclimb
driver (``python -m repro_torch.launch.hillclimb``). Steps on a mesh of
more than one device wait for ROADMAP Queue 1 item 15's execution
half."""
