"""The port's alignment methods (`vsc22_tpu_torch/align/`) against the JAX
package's on the CPU: DTW, DP, TN and HV on seeded random and planted
maps, the DP fill of the host library (`csrc/vta_kernels.cpp`) against
the JAX package's numpy fill and the port's own `dp_matrix_reference`,
native TN against the port's `tn_reference`, `build_vta_model` with each
method, the VCSL segment metrics, and `vcsl_io`'s readers, writers and
datasets.

Boxes, fills and metrics must be identical: both sides run the same
float64 arithmetic in the same order. The JAX side stays off its own
lazily built native library (`vsc22_tpu.native`): its callers take their
numpy paths, which that library matches bit for bit.
"""

import numpy as np
import pytest

from vsc22_tpu.align import metrics as jmetrics
from vsc22_tpu.align import vcsl_io as jio
from vsc22_tpu.align import vta as jvta
from vsc22_tpu_torch.align import metrics as pmetrics
from vsc22_tpu_torch.align import vcsl_io as pio
from vsc22_tpu_torch.align import vta as pvta


@pytest.fixture(autouse=True)
def jax_align_in_numpy(monkeypatch):
    """Keep every JAX call in this file off `vsc22_tpu.native`'s lazy
    build (its callers import `load_library` at call time)."""
    import vsc22_tpu.native

    monkeypatch.setattr(vsc22_tpu.native, "load_library", lambda: None)


def maps():
    """Planted diagonals (offset, broken, two copies) and noise, seeded."""
    rng = np.random.default_rng(21)
    out = []
    for q, r, off in ((40, 60, 3), (25, 25, 0), (33, 17, -4), (50, 45, 10)):
        sims = rng.normal(0, 0.1, (q, r))
        i = np.arange(max(0, -off), min(q, r - off))
        sims[i, i + off] += 0.8
        out.append(sims)
    two = rng.normal(0, 0.1, (60, 60))
    two[np.arange(5, 20), np.arange(30, 45)] += 0.9
    two[np.arange(35, 55), np.arange(2, 22)] += 0.9
    out.append(two)
    out += [rng.normal(0, s, (36, 44)) for s in (0.3, 0.6)]
    out.append(rng.uniform(-1, 1, (12, 70)))
    out.append(np.zeros((10, 10)))
    return out


METHODS = [
    ("dtw", {}), ("dtw", {"discontinue": 5, "min_sim": 0.1, "min_length": 3}),
    ("dp", {}), ("dp", {"discontinue": 5, "min_sim": 0.9, "ave_sim": 1.2, "min_length": 3}),
    ("hv", {}), ("hv", {"iou_thresh": 0.5, "min_sim": 0.3, "max_peaks": 10}),
]


@pytest.mark.parametrize("name,kwargs", METHODS, ids=[f"{n}-{i}" for i, (n, _) in
                                                      enumerate(METHODS)])
def test_method_boxes_match_jax(name, kwargs):
    for sims in maps():
        assert getattr(pvta, name)(sims, **kwargs) == getattr(jvta, name)(sims, **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"tn_max_step": 5, "tn_top_k": 3},
                                    {"max_path": 3, "min_sim": 0.1, "min_length": 3,
                                     "max_iou": 0.5}])
def test_native_tn_matches_jax_and_reference(kwargs):
    for sims in maps():
        got = pvta.tn(sims, **kwargs)
        assert got == jvta._tn_numpy(sims, **kwargs) == pvta.tn_reference(sims, **kwargs)


def test_each_method_finds_a_planted_copy():
    """Each method on a map with one planted copy (q 10-39 against r 10-39,
    or r 15-44 for TN) finds a box that covers it to within 2 frames, as
    the JAX tests ask (DTW's path runs corner to corner, so its box may run
    on past the copy)."""
    rng = np.random.default_rng(22)
    idx = np.arange(10, 40)
    cases = []
    sim = rng.random((50, 50)) * 0.1
    sim[idx, idx] = 0.95
    cases.append(("dtw", sim, {"min_sim": 0.3}, 0))
    sim = rng.random((50, 50)) * 0.1 - 0.5
    sim[idx, idx] = 0.9
    cases.append(("dp", sim, {}, 0))
    sim = rng.random((50, 60)) * 0.05
    sim[idx, idx + 5] = 0.9
    cases.append(("tn", sim, {}, 5))
    sim = rng.random((50, 50)) * 0.05
    sim[idx, idx] = 0.9
    cases.append(("hv", sim, {}, 0))
    for name, sim, kwargs, off in cases:
        boxes = getattr(pvta, name)(sim, **kwargs)
        assert boxes == getattr(jvta, name)(sim, **kwargs)
        assert any(q0 <= 12 and r0 <= 12 + off and q1 >= 37 and r1 >= 37 + off
                   for q0, r0, q1, r1 in boxes), (name, boxes)


@pytest.mark.parametrize("discontinue,min_sim", [(3, 1.0), (0, 0.5), (6, 1.2)])
def test_native_dp_fill_bit_for_bit(discontinue, min_sim):
    for sims in maps():
        shifted = np.asarray(sims, np.float64) + 1.0
        native = pvta._dp_matrix(shifted, discontinue, min_sim)
        for got, ref, jax_ in zip(native, pvta.dp_matrix_reference(shifted, discontinue, min_sim),
                                  jvta._dp_matrix(shifted, discontinue, min_sim)):
            assert got.dtype == ref.dtype == jax_.dtype
            assert np.array_equal(got, ref) and np.array_equal(got, jax_)


def test_build_vta_model_serves_every_method():
    data = [(f"k{i}", m) for i, m in enumerate(maps())]
    for method, fn in (("DTW", pvta.dtw), ("DP", pvta.dp), ("TN", pvta.tn), ("HV", pvta.hv)):
        got = pvta.build_vta_model(method).forward_sim(data)
        assert got == jvta.build_vta_model(method).forward_sim(data)
        assert got == [(k, fn(m)) for k, m in data]
    assert pvta.build_vta_model().func_to_run.func is pvta.dtw  # JAX's default
    with pytest.raises(ValueError):
        pvta.build_vta_model("XYZ")


def test_helpers_match_jax():
    rng = np.random.default_rng(23)
    for _ in range(20):
        a = rng.integers(0, 3, 30)
        np.testing.assert_array_equal(pvta.zero_runs(a), jvta.zero_runs(a))
        steps = rng.integers(0, 2, (40, 2))
        path = np.cumsum(steps, axis=0)
        np.testing.assert_array_equal(pvta.cut_path(path, 3), jvta.cut_path(path, 3))
    cost = rng.random((13, 17))
    np.testing.assert_array_equal(pvta._dtw_accumulate(cost), jvta._dtw_accumulate(cost))


def test_segment_metrics_match_jax():
    rng = np.random.default_rng(24)
    preds, gts = {}, {}
    for i in range(12):
        gt = np.sort(rng.integers(0, 100, (rng.integers(1, 3), 2, 2)), axis=1)
        gts[(f"Q{i}", f"R{i}")] = [[g[0, 0], g[0, 1], g[1, 0], g[1, 1]] for g in gt]
        if i % 4:
            pr = np.sort(rng.integers(0, 100, (rng.integers(1, 4), 2, 2)), axis=1)
            preds[(f"Q{i}", f"R{i}")] = [[p[0, 0], p[0, 1], p[1, 0], p[1, 1]] for p in pr]
    for key in gts:
        assert (pmetrics.segment_precision_recall(preds.get(key, []), gts[key])
                == jmetrics.segment_precision_recall(preds.get(key, []), gts[key]))
    assert pmetrics.evaluate_alignment(preds, gts) == jmetrics.evaluate_alignment(preds, gts)
    assert pmetrics.evaluate_alignment({}, {}) == jmetrics.evaluate_alignment({}, {})


def test_vcsl_io_round_trips_and_pair_order(tmp_path):
    values = {"bytes": (b"\x00\x01abc", "a.bin"), "numpy": (np.arange(6.0).reshape(2, 3), "a.npy"),
              "json": ({"k": [1, 2], "s": "x"}, "a.json")}
    for data_type, (value, name) in values.items():
        pio.build_writer("local", data_type)(str(tmp_path / name), value)
        got = pio.build_reader("local", data_type)(str(tmp_path / name))
        want = jio.build_reader("local", data_type)(str(tmp_path / name))
        if data_type == "numpy":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, value)
        else:
            assert got == want == value
    with pytest.raises(NotImplementedError):
        pio.build_reader("oss", "bytes")
    with pytest.raises(ValueError):
        pio.build_reader("local", "video")

    files = []
    for i in range(5):
        path = tmp_path / f"v{i}.npy"
        np.save(path, np.full(3, i, np.float32))
        files.append((f"id{i}", path.name))
    items = pio.ItemDataset(files, root=str(tmp_path), data_type="numpy")
    assert len(items) == 5 and items[2][0] == "id2" and items[2][1][0] == 2.0
    qs, gs = files[:2], files[2:]
    for kwargs in ({"query_list": qs, "gallery_list": gs},
                   {"pair_list": [("id0", "id3"), ("id4", "id1")], "file_dict": dict(files)}):
        got = pio.PairDataset(root=str(tmp_path), data_type="numpy", **kwargs)
        want = jio.PairDataset(root=str(tmp_path), data_type="numpy", **kwargs)
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            (gq, gg, gqv, ggv), (wq, wg, wqv, wgv) = got[i], want[i]
            assert (gq, gg) == (wq, wg)
            np.testing.assert_array_equal(gqv, wqv)
            np.testing.assert_array_equal(ggv, wgv)

    writer = pio.AsyncWriter(3, data_type="json")
    for i in range(10):
        writer.consume((str(tmp_path / f"w{i}.json"), {"i": i}))
    writer.stop()
    assert all(not w.is_alive() for w in writer.workers)
    assert [pio.build_reader(data_type="json")(str(tmp_path / f"w{i}.json"))["i"]
            for i in range(10)] == list(range(10))
