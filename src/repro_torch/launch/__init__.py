"""Launchers of the port (counterpart of ``repro.launch``): the PoFEL
trainer's (``python -m repro_torch.launch.train``) and the serving
launcher's (``python -m repro_torch.launch.serve``). The reference's mesh
launchers (dryrun, specs, costs, roofline, hillclimb) wait for the mesh
half of ROADMAP Queue 1 item 15."""
