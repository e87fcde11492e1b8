"""One-off measurements that set the benchmark's numbers, run on the
card once when a cell is defined (never by the benchmark's runs):
`sweep.py` finds the knee rate of a cell and reads the program's and the
control's checks over many seeds."""
