"""Plain PyTorch references of the benchmark's configurations; they import
nothing of the program."""
