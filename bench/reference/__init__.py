"""Plain PyTorch references of what the benchmark's cells run; nothing
here imports the program."""
