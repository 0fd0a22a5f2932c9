"""DP backend equivalence: numpy oracle == native C++ solver == device
rowscan (plain JAX, here on the CPU backend), bit for bit."""

import numpy as np
import pytest

from mandalorion_tpu.align.extend import DpProblem, solve_dp_numpy
from mandalorion_tpu.align.kernels import solve_dp_rowscan
from mandalorion_tpu.config import AlignConfig

MAXT = 127  # single 128-lane bucket bound (this file's small-case regime)

CFG = AlignConfig()


def _random_problems(rng, n, mode, max_len=100):
    problems = []
    for _ in range(n):
        nq = int(rng.integers(1, max_len))
        q = rng.integers(0, 4, size=nq).astype(np.uint8)
        t = list(q)
        for _e in range(int(rng.integers(0, 6))):
            kind = rng.integers(0, 3)
            p = int(rng.integers(0, max(len(t), 1)))
            if kind == 0 and t:
                t[p] = int(rng.integers(0, 4))
            elif kind == 1:
                t.insert(p, int(rng.integers(0, 4)))
            elif t:
                del t[p]
        t = np.asarray(t[:MAXT], np.uint8)
        problems.append(DpProblem(q, t, mode))
    return problems


def _assert_same(ref, got, tag):
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g.ops == r.ops, f"{tag} problem {k}: {g.ops} != {r.ops}"
        assert (g.q_len, g.t_len) == (r.q_len, r.t_len), f"{tag} {k}"


@pytest.mark.parametrize("mode,bonus", [("global", 0),
                                        ("extend_right", 0),
                                        ("extend_right", 12),
                                        ("extend_left", 12)])
def test_rowscan_matches_oracle(mode, bonus):
    cfg = AlignConfig(end_bonus=bonus)
    rng = np.random.default_rng((abs(hash(mode)) + bonus) % 2 ** 31)
    problems = _random_problems(rng, 60, mode)
    _assert_same(solve_dp_numpy(problems, cfg),
                 solve_dp_rowscan(problems, cfg), f"{mode}-b{bonus}")


def test_rowscan_dissimilar_extend():
    rng = np.random.default_rng(5)
    problems = []
    for _ in range(24):
        nq = int(rng.integers(8, 100))
        q = rng.integers(0, 4, size=nq).astype(np.uint8)
        t = q.copy()
        cut = int(rng.integers(1, nq))
        t[cut:] = (t[cut:] + 1 + rng.integers(0, 3, size=nq - cut)) % 4
        problems.append(DpProblem(q, t, "extend_right"))
    _assert_same(solve_dp_numpy(problems, CFG),
                 solve_dp_rowscan(problems, CFG), "dissimilar")


def test_rowscan_oversize_falls_back():
    rng = np.random.default_rng(6)
    q = rng.integers(0, 4, size=400).astype(np.uint8)
    problems = [DpProblem(q, q.copy(), "global"),
                DpProblem(q[:20], q[:20].copy(), "global")]
    _assert_same(solve_dp_numpy(problems, CFG),
                 solve_dp_rowscan(problems, CFG), "oversize")


@pytest.mark.parametrize("mode,bonus", [("global", 0),
                                        ("extend_right", 0),
                                        ("extend_right", 12),
                                        ("extend_left", 12)])
def test_native_dp_matches_oracle(mode, bonus):
    from mandalorion_tpu.align.extend import solve_dp_native
    from mandalorion_tpu.native import load_native
    if load_native() is None:
        pytest.skip("no native toolchain")
    cfg = AlignConfig(end_bonus=bonus)
    rng = np.random.default_rng((abs(hash(mode)) + bonus) % 2 ** 31)
    problems = _random_problems(rng, 80, mode)
    # include edge problems: empty q, empty t, exact prefix
    problems.append(DpProblem(np.zeros(0, np.uint8),
                              rng.integers(0, 4, 9).astype(np.uint8), mode))
    problems.append(DpProblem(rng.integers(0, 4, 9).astype(np.uint8),
                              np.zeros(0, np.uint8), mode))
    q = rng.integers(0, 4, 30).astype(np.uint8)
    problems.append(DpProblem(q, np.concatenate(
        [q, rng.integers(0, 4, 10).astype(np.uint8)]), mode))
    _assert_same(solve_dp_numpy(problems, cfg),
                 solve_dp_native(problems, cfg), f"native-{mode}-b{bonus}")


def _zdrop_problems(rng, n):
    """Extensions where a matching head is followed by unrelated junk —
    the case zdrop exists for (stop instead of wading through noise)."""
    problems = []
    for _ in range(n):
        head = int(rng.integers(5, 60))
        junk = int(rng.integers(0, 80))
        t_head = rng.integers(0, 4, size=head).astype(np.uint8)
        q = np.concatenate([t_head,
                            rng.integers(0, 4, size=junk).astype(np.uint8)])
        t = np.concatenate([t_head, (3 - rng.integers(0, 4, size=junk + 10))
                            .astype(np.uint8)])[:MAXT]
        # bury an exact-prefix fast path trigger sometimes
        problems.append(DpProblem(q, t, "extend_right"))
    return problems


@pytest.mark.parametrize("zdrop,bonus", [(10, 0), (25, 12), (200, 0)])
def test_zdrop_identical_across_backends(zdrop, bonus):
    from mandalorion_tpu.align.extend import solve_dp_native
    rng = np.random.default_rng(77 + zdrop)
    cfg = AlignConfig(end_bonus=bonus, zdrop=zdrop)
    problems = (_zdrop_problems(rng, 40)
                + _random_problems(rng, 40, "extend_right"))
    ref = solve_dp_numpy(problems, cfg)
    _assert_same(ref, solve_dp_rowscan(problems, cfg), f"rowscan-z{zdrop}")
    _assert_same(ref, solve_dp_native(problems, cfg), f"native-z{zdrop}")


def test_zdrop_truncates_junk_extension():
    """With zdrop on, the extension stops near the matching head instead
    of chasing spurious matches deep into unrelated sequence."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 4, size=30).astype(np.uint8)
    q = np.concatenate([head, rng.integers(0, 4, size=90).astype(np.uint8)])
    t = np.concatenate([head,
                        (3 - rng.integers(0, 4, size=97)).astype(np.uint8)])
    t = t[:MAXT]
    p = [DpProblem(q, t, "extend_right")]
    res_z = solve_dp_numpy(p, AlignConfig(zdrop=12))[0]
    assert res_z.q_len >= 30           # the head is still consumed
    assert res_z.q_len <= 30 + 12 + 5  # but junk is not


@pytest.mark.parametrize("n", [2, 8])
def test_backends_sharded_over_mesh_identical(n):
    """With a pipeline mesh installed, the rowscan dispatch shards its
    problem batch over the devices and stays bit-identical to the
    oracle."""
    from mandalorion_tpu.parallel.mesh import make_mesh, use_mesh

    cfg = AlignConfig(end_bonus=12)
    rng = np.random.default_rng(77)
    problems = _random_problems(rng, 21, "extend_right")  # ragged batch
    ref = solve_dp_numpy(problems, cfg)
    with use_mesh(make_mesh(n)):
        _assert_same(ref, solve_dp_rowscan(problems, cfg),
                     f"rowscan-mesh{n}")


@pytest.mark.parametrize("mode", ["global", "extend_right"])
def test_wide_envelope_matches_oracle(mode):
    """Targets beyond 127 lanes and queries beyond 256 rows run on device
    (width-bucketed lanes, quantized row caps) and stay bit-identical to
    the host oracle — the end-extension envelope (VERDICT r1 #4)."""
    from mandalorion_tpu.align.kernels import MAX_T_DEVICE, _width_for

    rng = np.random.default_rng(99)
    cfg = AlignConfig(end_bonus=12)
    problems = []
    for nq, nt in ((40, 300), (300, 290), (600, 700), (150, 1100),
                   (900, 961)):
        q = rng.integers(0, 4, size=nq).astype(np.uint8)
        t = q[:min(nq, nt)].copy()
        t[rng.integers(0, len(t), size=8)] = 0  # sprinkle mismatches
        pad = rng.integers(0, 4, size=max(0, nt - len(t))).astype(np.uint8)
        problems.append(DpProblem(q, np.concatenate([t, pad]), mode))
    assert all(len(p.t) <= MAX_T_DEVICE for p in problems)
    assert {_width_for(len(p.t)) for p in problems} >= {512, 1024, 2304}
    ref = solve_dp_numpy(problems, cfg)
    _assert_same(ref, solve_dp_rowscan(problems, cfg), f"rowscan-{mode}")


def test_device_fallback_only_degenerate():
    """Host fallback now covers only degenerate problems."""
    from mandalorion_tpu.align.kernels import MAX_Q_DEVICE, MAX_T_DEVICE

    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, size=MAX_Q_DEVICE + 1).astype(np.uint8)
    t = rng.integers(0, 4, size=MAX_T_DEVICE + 1).astype(np.uint8)
    small_q = q[:50]
    small_t = t[:60]
    problems = [DpProblem(q, small_t, "global"),      # too many rows
                DpProblem(small_q, t, "global"),      # too wide
                DpProblem(small_q, small_t, "global")]
    ref = solve_dp_numpy(problems, CFG)
    _assert_same(ref, solve_dp_rowscan(problems, CFG), "fallback-mix")
