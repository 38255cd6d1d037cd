"""Launchers of the PyTorch port: the LLM serving loop
(``repro_torch.launch.serve``)."""

__all__: list = []
