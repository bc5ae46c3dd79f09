"""One module per traffic kind: `run(cell, seed, seconds, trace, device,
t_process, control=False)` drives the program and judges what it produced
(with `control`, the plain reference in TF32 stands in for the program's
model: the cell's lower-precision control)."""
