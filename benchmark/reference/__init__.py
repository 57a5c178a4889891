"""The benchmark's plain reference (tracer.py): plain PyTorch, importing
nothing of the program."""
