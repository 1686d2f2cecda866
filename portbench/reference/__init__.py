"""Plain NumPy references of the configurations: the exact spectrum
worked out again from the raw inputs, and the operators applied by array
shifts on the grid. Nothing here imports the port or takes what it made."""
