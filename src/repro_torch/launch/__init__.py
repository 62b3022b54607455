"""Launchers of the port (counterpart of ``repro.launch``): the PoFEL
trainer's (``python -m repro_torch.launch.train``). The reference's
mesh launchers (serve, dryrun, specs, costs, roofline, hillclimb) wait
for the mesh half of ROADMAP Queue 1 item 15."""
