"""The plain reference of the benchmark's models: PyTorch operations in
float32, layer by layer, with no kernel, cache or batching of the program
(``repro_torch``), which it never imports."""
