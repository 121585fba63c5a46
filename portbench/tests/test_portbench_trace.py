"""The reduction of a profiler stretch: idle gaps named by what the host
was doing."""

from portbench.trace import idle_gaps


def test_idle_gaps_are_named_by_the_host():
    dev = [(0, 10, "k1"), (20, 30, "k2"), (25, 40, "k3"), (100, 110, "k4")]
    host = [(5, 50, "aten::a"), (6, 40, "aten::a_inner"), (60, 70, "aten::b"),
            (95, 99, "aten::launch"), (96, 97, "cudaLaunchKernel")]
    gaps = dict(idle_gaps(dev, host))
    assert gaps == {"host Python, then aten::launch": 60e-9, "host in aten::a": 10e-9}
