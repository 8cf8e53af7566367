"""The benchmark's plain reference: the networks, the FPD training step
and the serving path in plain PyTorch, float32 with TF32 off.  It imports
nothing of the program it judges."""
