"""Operation and byte counts of the served work, and the card's peaks.

Each function counts what the inputs need, not what a kernel happens to do:
each input byte read once and each output byte written once per unit of
work the docstring names, and the operations of the algorithm.  A kernel's
roofline share is the least time the card could take for that work (the
larger of bytes over peak bandwidth and operations over peak rate) over the
device time the kernel took.
"""
