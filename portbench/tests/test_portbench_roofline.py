"""The yardstick's arithmetic against the numbers chip_smoke.py prints."""

import pytest

from portbench import roofline

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_k3_bound_equals_chip_smoke():
    nbytes, imads = roofline.lde_work(136, 1 << 16, 3, roofline.k3_table_words(16, 3))
    ms, by = roofline.bound(nbytes, imads, H100)
    assert by == "bytes"
    assert ms == pytest.approx(0.2132, abs=5e-5)


def test_k1_bound_equals_chip_smoke():
    ms, by = roofline.bound(*roofline.poseidon_work(1 << 17), H100)
    assert by == "operations"
    assert ms == pytest.approx(0.0522, abs=5e-5)


def test_commit_bound_of_the_ecdsa_cell():
    # 2^19 leaves of 136 elements: 17 permutations each, and 2^19 - 16 nodes
    assert roofline.tree_permutations(1 << 19, 136, 4) == 17 * (1 << 19) + (1 << 19) - 16
    ms = roofline.commit_bound_ms(136, 16, 3, 4, H100)
    assert 3.9 < ms < 4.1                  # ~0.21 ms LDE + ~3.76 ms Poseidon


def test_busy_us_is_the_union_of_intervals():
    assert roofline.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert roofline.busy_us([]) == 0


def test_peaks_need_a_known_card():
    with pytest.raises(KeyError):
        roofline.peaks("cpu")
