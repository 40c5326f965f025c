"""Each kernel's bytes, operations and bound, pinned to the bounds the
kernel table gives at its shapes (H100: 3.35 TB/s; 989 TFLOP/s bf16, 67
float32, 495/3 float32 in 3xTF32)."""
import pytest

from port_bench.harness import manifest as M
from port_bench.harness.peaks import bound_s

CASES = [
    # kernel, shape, MB (None: not pinned), bound in µs, bound by
    ("cifg_cell_fwd", dict(C=1, S=1, B=256, H=256), 2.23, 0.665, "bytes"),
    ("cifg_cell_fwd", dict(C=1, S=16, B=10, H=256), 1.23, 0.368, "bytes"),
    ("cifg_cell_fwd", dict(C=1, S=5, B=27648, H=256), 764.8, 228.30,
     "bytes"),
    ("cifg_cell_fwd", dict(C=16, S=16, B=10, H=256), 19.7, 5.888, "bytes"),
    ("cifg_cell_fwd", dict(C=16, S=16, B=10, H=256, w_bytes=4), None, 15.02,
     None),
    ("cifg_cell_bwd_seq", dict(C=1, S=16, B=10, H=256), None, 0.957,
     "operations"),
    ("cifg_cell_bwd_seq", dict(C=16, S=16, B=10, H=256), None, 15.32,
     "operations"),
    ("ssd_scan", dict(B=4, S=512, H=80, p=64, N=64), 69.3, 23.13,
     "operations"),
    ("ssd_scan", dict(B=1, S=512, H=32, p=64, N=128), None, 3.80, None),
    ("ssd_scan", dict(B=8, S=128, H=32, p=64, N=128, a_rows=True), None,
     6.456, "bytes"),
    ("dp_sumsq", dict(C=16, n=1278720), 81.84, 24.43, "bytes"),
    ("dp_sumsq", dict(C=1, n=1278720), None, 1.53, "bytes"),
    ("dp_clip_accumulate", dict(C=16, n=983040), 70.8, 21.13, "bytes"),
]


@pytest.mark.parametrize("kernel,shape,mb,us,by", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_pinned_bound(kernel, shape, mb, us, by):
    mod = M.kernel_counts(kernel)
    nbytes, ops = mod.counts(**shape)
    if mb is not None:
        assert nbytes / 1e6 == pytest.approx(mb, abs=0.06)
    seconds, what = mod.bound(**shape)
    assert seconds * 1e6 == pytest.approx(us, rel=2e-3, abs=5e-3)
    if by is not None:
        assert what == by
    assert mod.KERNELS_PER_CALL >= 1 and mod.KERNEL_NAMES


def test_ssd_operations():
    _, ops = M.kernel_counts("ssd_scan").counts(4, 512, 80, 64, 64)
    assert ops["float32_3xtf32"] / 1e9 == pytest.approx(3.72, abs=0.01)


def test_bound_takes_the_larger():
    assert bound_s(3.35e12, {"bfloat16": 1.0}) == (1.0, "bytes")
    assert bound_s(0.0, {"float32": 67e12})[1] == "operations"
