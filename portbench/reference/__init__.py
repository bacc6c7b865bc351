"""The plain float32 reference: its layers (``ops.py``), the Dice loss,
SGD and the COVID-QU metric set in plain PyTorch, numpy and scipy.  The
models are the architecture modules of ``portbench/archs/``.  It imports
nothing of the program."""
