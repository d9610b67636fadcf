"""Hand-written CUDA kernels of the port, their plain torch versions
(``ref.py``) and the public entry points (``ops.py``)."""
