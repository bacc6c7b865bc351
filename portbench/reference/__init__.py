"""The plain float32 reference: the two U-Nets, the Dice loss, SGD and the
COVID-QU metric set in plain PyTorch, numpy and scipy.  It imports nothing
of the program."""
