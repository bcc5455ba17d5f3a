"""The roofline arithmetic against the bound figures of PERF.md's kernel
table, from the shapes (CPU)."""

import pytest

from gpubench import roofline


def ms(work, dtype):
    return round(1e3 * roofline.least_time(*work, dtype)[0], 4)


@pytest.mark.parametrize("dtype,want", [("float32", 0.0040),
                                        ("float64", 0.0081)])
def test_wavefront_solve_at_750(dtype, want):
    """B1 and B7 alike: four fields read and two written over 750^2 cells,
    bound by bytes."""
    work = roofline.wavefront_solve(750, 750, dtype)
    assert ms(work, dtype) == want
    assert roofline.least_time(*work, dtype)[1] == "bytes"


@pytest.mark.parametrize("dtype,want", [("float32", 0.6704),
                                        ("float64", 1.3210)])
def test_whole_trajectories_of_nine_points(dtype, want):
    """B6 on the 250^2 bench mesh (1,508 weighted cells, 95 modes), 9
    points x 50 steps, bound by operations. The table does not record
    that run's counts: 930 updates and 1,350 systems (three a step)
    reproduce both figures (928-932 do)."""
    work = roofline.hprom_trajectories(1508, 95, 50, 9, 930, 1350, 24, dtype)
    assert ms(work, dtype) == want
    assert roofline.least_time(*work, dtype)[1] == "operations"


def test_systems_needed_bound_the_systems_built():
    """Each step builds one system per update and one more where it stops
    early: the count of needed systems never exceeds what was built."""
    import itertools

    for per_step in itertools.product(range(4), repeat=4):
        its = sum(per_step)
        built = sum(min(i + 1, 3) for i in per_step)
        need = roofline.hprom_evals_needed(its, 4, 1, 3)
        assert its <= need <= built


class _Event:
    def __init__(self, start, end, name, on_device):
        self._s, self._e, self._n, self._d = start, end, name, on_device

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)


def test_busy_time_is_the_union_and_idle_is_read_against_untraced_seconds():
    """Overlapping kernels count once; a gap is named by the host event
    that covers it; the idle share is taken against the untraced seconds
    of the same requests, not the traced window."""
    from gpubench.trace import reduce_events

    ms = 1_000_000
    events = [_Event(0, 4 * ms, "k1", True), _Event(2 * ms, 5 * ms, "k2", True),
              _Event(7 * ms, 8 * ms, "Memcpy DtoD", True),
              _Event(4 * ms, 9 * ms, "aten::is_nonzero", False)]
    st = reduce_events(events, window_s=0.010)
    assert abs(st.busy_s - 0.006) < 1e-12
    assert st.kernel_count == 2 and set(st.copies) == {"Memcpy DtoD"}
    assert st.gaps == [("host: aten::is_nonzero", 0.002)]
    assert st.idle_pct is None
    st.untraced_s = 0.008
    assert abs(st.idle_pct - 25.0) < 1e-9
