"""The benchmark's general machinery: finding a cell's files by name
(spec), the window, trace and check of a run (runner), the work counts and
peaks (work) and the command line (cli)."""
