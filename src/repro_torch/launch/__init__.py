"""Launchers of the PyTorch port: the LLM serving loop
(``repro_torch.launch.serve``), the training loop
(``repro_torch.launch.train``), the production meshes
(``repro_torch.launch.mesh``) and the dry run of every (arch × shape ×
mesh) cell on the ``meta`` device (``repro_torch.launch.dryrun``, over
``repro_torch.launch.trace_analysis``)."""

__all__: list = []
