"""Launchers of the PyTorch port: the LLM serving loop
(``repro_torch.launch.serve``), the training loop
(``repro_torch.launch.train``) and the production meshes
(``repro_torch.launch.mesh``)."""

__all__: list = []
