"""The plain reference that decides a run's `correct`.

Plain PyTorch and NumPy only: frozen copies of the port's plain paths (the
DTOID network, its losses and optimizer, the Zephyr scorer with its device
ICP, the template reader, the PNG and PLY readers), with every hand-written
kernel replaced by its plain arithmetic (`conv.py`, `sa_fused.py`). Nothing
here imports the program; `world.py` reads the benchmark's world from its
files and re-derives what the loop derives from them.
"""
