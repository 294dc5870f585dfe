"""Plain reference of the benchmarked computations.

Straightforward PyTorch (or NumPy) written from the mathematics, with no
kernel, no batching trick and nothing imported from the program: it builds
its own designs and bases, and computes in whatever dtype it is handed
(float64 for the reference, float32 with TF32 on for the control). The
tests hold it to the program at tiny sizes; on the card it judges what the
timed path produced.
"""
