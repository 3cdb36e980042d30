"""Plain reference of MHAP's overlap search, against which the benchmark
judges what the port printed.

Written from marbl/MHAP v2.1.3's definitions in plain PyTorch (elementwise
integer operations, sorts and reductions, on whatever device it is handed)
and plain Python/NumPy for the second-stage scorer; it imports nothing of
the program under test and takes nothing the program made: it hashes,
sketches, filters, votes, scores and formats from the reads and the filter
file alone.
"""
