"""The plain PyTorch references that decide ``correct``.

They import nothing of the port, take nothing the port made, and work out
again what the port derives (cohorts, example rows, draws). Every product
runs in float32 with TF32 off (`precision.exact_matmul`), or in a lower
precision for the control (`precision.cast`).
"""
