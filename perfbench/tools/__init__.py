"""Tools that read a cell's runs beyond its result line: ``split`` puts a
traced slice's device idle down to the program's spans."""
