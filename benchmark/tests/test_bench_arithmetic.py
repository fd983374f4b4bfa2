"""The benchmark's metric arithmetic and roofline counts, against hand counts."""

import types

import pytest

from benchmark.lib import roofline, spec
from benchmark.lib import trace as tr


def _reader(name):
    return spec.reader(name)


def test_rate_is_all_work_over_all_time():
    ctx = dict(unit_rows=[100, 100, 300], window_s=2.5)
    assert _reader("check_rows_per_s")(ctx) == pytest.approx(200.0)


def test_proof_readers_over_the_whole_window():
    ctx = dict(unit_rows=[64, 64, 0], window_s=4.0,
               spans=dict(prove_ms=[10.0, 30.0, 20.0], verify_ms=[1.0, 2.0, 3.0]))
    assert _reader("prove_rows_per_s")(ctx) == pytest.approx(32.0)
    assert _reader("prove_ms")(ctx) == pytest.approx(20.0)
    assert _reader("verify_ms")(ctx) == pytest.approx(2.0)
    assert _reader("prove_rows_per_s")(dict(unit_rows=[], window_s=4.0)) is None
    assert _reader("prove_ms")(dict(spans={})) is None


def test_check_p90_is_over_every_check_of_the_window():
    ms = [float(v) for v in range(1, 101)]  # 100 checks of 1..100 ms
    # statistics.quantiles' exclusive method: the cut at 0.9 * 101 = 90.9
    assert _reader("check_ms_p90")(dict(unit_ms=ms)) == pytest.approx(90.9)
    # one slow check in ten moves the tail and hardly moves the mean
    ms = [10.0] * 80 + [50.0] * 20
    assert _reader("check_ms_p90")(dict(unit_ms=ms)) == pytest.approx(50.0)
    assert _reader("check_ms_p90")(dict(unit_ms=[5.0] * 9)) is None  # too few to have a tail
    assert _reader("check_ms_p90")(dict(unit_ms=[])) is None  # no card clock (the CPU)


def _trace(device, window=(0, 100)):
    return tr.Trace(window=window, device=[(n, a, b) for n, a, b in device], host=[])


def test_idle_counts_overlapping_device_intervals_once():
    t = _trace([("k1", 10, 30), ("k2", 20, 40), ("k3", 60, 70), ("Memcpy DtoH", 65, 80)])
    assert tr.union_ns([(a, b) for _, a, b in t.device]) == 30 + 20
    ctx = dict(trace=t)
    assert _reader("device_idle_pct.check")(ctx) == pytest.approx(50.0)
    assert tr.gaps([(10, 30), (20, 40), (60, 80)], (0, 100)) == [(0, 10), (40, 60), (80, 100)]


def test_kernels_per_check_leaves_out_copies():
    t = _trace([("k1", 10, 30), ("k2", 20, 40), ("Memset (Device)", 50, 51),
                ("Memcpy DtoH", 65, 80)])
    assert _reader("kernels_per_check")(dict(trace=t, traced_units=2)) == 1.0


def test_breakdown_names_gaps_by_the_innermost_host_event():
    t = tr.Trace(window=(0, 100), device=[("k", 10, 90)],
                 host=[("bench.unit", 0, 100), ("aten::nonzero", 85, 100)])
    b = tr.breakdown(t)
    assert b["device_ops"] == [["k", 80e-9]]
    assert b["idle_gaps"] == [["bench.unit", 10e-9], ["aten::nonzero", 10e-9]]


def test_permutation_count_by_hand():
    # products: 8 full rounds x 12 lanes x 4, 22 partial rounds x (4 + 12)
    assert roofline.PRODUCTS_PER_STATE == 384 + 352 == 736
    # additions: 9 M_E x 62, 96 round constants, 22 x (1 + 11 + 12)
    assert roofline.ADDITIONS_PER_STATE == 558 + 96 + 528 == 1182
    assert roofline.INT32_INSTR_PER_STATE == 736 * 20 + 1182 * 6 == 21812


def test_bounds_by_hand():
    sms, clock = 132, 1.98e9
    lanes_per_s = 132 * 64 * 1.98e9
    # a million states: bound by integer instructions, not by 192 MB of bytes
    assert roofline.permutation_bound_s(1 << 20, sms, clock) == pytest.approx(
        (1 << 20) * 21812 / lanes_per_s)
    # a chain with no executed row is bound by its bytes
    assert roofline.chain_bound_s(0, 1000, 10, sms, clock) == pytest.approx(
        (1000 * 65 + 21 * 96) / 3.35e12)
    assert roofline.chain_bound_s(1 << 21, 1 << 21, 4096, sms, clock) == pytest.approx(
        (1 << 21) * 21812 / lanes_per_s)


def test_roofline_readers_are_silent_without_their_kernel():
    t = _trace([("other", 0, 50)])
    ctx = dict(trace=t, traced_units=3, permutation_states=1 << 20, sm_count=132,
               clock_hz=1.98e9, work=dict(chain_rows=1 << 21, all_rows=1 << 21,
                                         chain_segments=4096))
    assert _reader("p2_perm_roofline.check")(ctx) is None
    assert _reader("p2_chain_roofline.check")(ctx) is None
    t = _trace([("poseidon2_permute_kernel(unsigned long const*)", 0, 1_000_000)])
    share = _reader("p2_perm_roofline.check")(dict(ctx, trace=t))
    bound = roofline.permutation_bound_s(1 << 20, 132, 1.98e9)
    assert share == pytest.approx(100 * bound / 1e-3)


def test_metric_reader_of_a_missing_trace_is_silent():
    assert _reader("device_idle_pct.check")(dict(trace=None)) is None
    assert _reader("witness_s")(dict(spans={})) is None
    assert _reader("setup_s")(types.MappingProxyType(dict(setup_s=3.5))) == 3.5
