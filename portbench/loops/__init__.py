"""The loops that drive the program, one module per traffic ``kind``."""
