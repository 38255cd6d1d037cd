"""Share of the traced prefill window in which no device operation ran, in
%."""
from benchlib import readers


def read(r):
    return readers.idle_pct(r)
