"""The benchmark's plain reference of the EM epoch.

Plain PyTorch and NumPy.  Nothing here imports the program under test or
anything it made: the reference works out again, from the benchmark's own
inputs (data, images, the seed) and from the program state it is handed
(the parameters before an epoch and the state sets after it), what one
epoch has to produce, and the comparison judges the program's outputs
against that.  Frozen copies (the bound arithmetic, the initial-state
draw) carry a header naming where they were copied from; later changes
of the program do not reach them.
"""
