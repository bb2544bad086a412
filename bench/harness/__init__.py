"""The benchmark's harness: cells found by name, the traffic generator,
the runs of training and serving cells, the traced sub-window and the
output checks. Nothing here imports the program at module level."""
