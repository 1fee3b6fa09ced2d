"""The plain reference of the cells' entries (``vplain``), which imports
nothing of the program."""
