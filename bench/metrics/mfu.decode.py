"""Decode's share of its least time: each step's operations at the bf16 peak
or its bytes (every weight once, the live K/V) at the HBM peak, whichever is
longer, summed over the traced window's steps and divided by the window, in
%."""
from benchlib import readers


def read(r):
    return readers.least_time_pct(r)
