"""The benchmark of the PyTorch and CUDA port: scheduling cells driven
through ``repro_torch``'s simulator, judged against a NumPy reference."""
