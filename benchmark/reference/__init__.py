"""The plain reference the benchmark holds the program to.

Plain PyTorch, in float64 on the card by default.  Nothing here imports
``diffus_tpu_torch`` or ``diffus_tpu``: each function is a frozen copy of
the mathematics the program states, written out again, and each names the
file of the program it follows.
"""
