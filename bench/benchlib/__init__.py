"""The benchmark's own library: the manifest, the import guard, the seeded
weights, the FLOP and byte arithmetic, the peaks, the trace reduction, the
comparison that decides ``correct`` and the result line.  Nothing here
imports the program (``repro_torch``) at import time."""
