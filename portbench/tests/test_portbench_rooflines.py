"""The work counts against sums worked by hand, and the kernels they
time read from the sources."""
import pytest

from portbench import core, rooflines
from portbench.trace import kernel_matcher, kernel_names


def test_fwd_work_by_hand():
    # 2 segments x (11 + 8 + 15) floats x 4 bytes + 3 iterations x a
    # table of 100 bytes; 2 x 450 operations
    ops, nbytes = rooflines.work("fwd", dict(segments=2, iterations=3,
                                             table_bytes=100))
    assert ops == 900 and nbytes == 2 * 136 + 300
    # 148,971,709 segments: 20.26 GB, bound by bytes: 6.048 ms
    c = dict(segments=148_971_709, iterations=1338, table_bytes=73_728)
    ops, nbytes = rooflines.work("fwd", c)
    assert nbytes == 148_971_709 * 136 + 1338 * 73_728
    assert rooflines.bound_s(ops, nbytes) == pytest.approx(
        nbytes / 3.35e12)
    assert rooflines.share("fwd", c, 2 * nbytes / 3.35e12) == \
        pytest.approx(50.0)


def test_train_work_by_hand():
    # lanes x n_iters x steps lane-iterations of 4 x (17 + 19 + 29 + 13)
    # bytes and 1,450 operations
    ops, nbytes = rooflines.work("train", dict(lanes=128, n_iters=10,
                                               steps=2))
    assert nbytes == 2560 * 312 and ops == 2560 * 1450
    assert rooflines.share("train", dict(lanes=128, n_iters=10, steps=2),
                           2 * 2560 * 312 / 3.35e12) == pytest.approx(50.0)


def test_nothing_measured_reads_nothing():
    assert rooflines.share("fwd", dict(segments=0, iterations=0,
                                       table_bytes=0), 1.0) is None
    assert rooflines.share("train", dict(lanes=1, n_iters=1, steps=1),
                           0.0) is None


def test_kernels_are_read_from_the_sources():
    names = kernel_names(core.ROOT / "raytrace_tpu_torch")
    assert {"bounce_kernel", "iter_kernel", "bounce_bwd_kernel",
            "row_sum_kernel"} <= names
    is_port = kernel_matcher(names)
    assert is_port("iter_kernel(IterArgs)")
    assert is_port("(anonymous namespace)::bounce_bwd_kernel(BwdArgs)")
    assert is_port("void (anonymous namespace)::iter_kernel<false, false, "
                   "true>(IterArgs)")
    assert is_port("void volume_crossings_kernel<true>(VolArgs)")
    assert is_port("void rt::row_map_kernel(rt::RowArgs, int)")
    assert not is_port("void at::native::vectorized_elementwise_kernel"
                       "<4, at::native::FillFunctor<float>>(int)")
    assert not is_port("my_iter_kernel(IterArgs)")


def test_a_kernel_added_later_is_counted(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "new.cu").write_text(
        "__global__ void __launch_bounds__(128)\nnew_kernel(int a) {}\n")
    (tmp_path / "k.py").write_text(
        "import triton\n@triton.jit\ndef tri_kernel(x):\n    pass\n")
    assert kernel_names(tmp_path) == {"new_kernel", "tri_kernel"}
