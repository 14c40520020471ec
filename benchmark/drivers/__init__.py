"""The loops that drive the program in a cell's window, one module per
``driver`` that a traffic file names."""
