"""Launchers of the PyTorch port: the LLM serving loop
(``repro_torch.launch.serve``) and the training loop
(``repro_torch.launch.train``)."""

__all__: list = []
