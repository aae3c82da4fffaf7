"""The port's pre-idle cause attribution (paper §4.5) and density
clustering against the JAX package's.

Mirrors the attribution and clustering cases of tests/test_telemetry.py:
the same windows and fingerprints, and the same cluster labels, category
labels and shares, exactly.
"""
import numpy as np
import pytest
from _hyp import given, settings, st

from repro_torch.core.attribution import (CATEGORIES, FEATURES,
                                          attribute_causes,
                                          extract_pre_idle_windows)
from repro_torch.core.clustering import density_cluster
from repro_torch.core.states import DeviceState


@pytest.fixture(scope="module")
def ref():
    from repro.core import attribution, clustering
    return attribution, clustering


def cause_series(seed: int):
    """tests/test_telemetry.py's fixture: 70 active bursts with a
    cause-signature tail, each followed by an execution-idle interval."""
    rng = np.random.default_rng(seed)
    states, sig = [], {k: [] for k in FEATURES}
    causes = (["pcie"] * 30) + (["nic"] * 15) + (["compute"] * 25)
    rng.shuffle(causes)
    for cause in causes:
        for phase, n in (("act", 8), ("tail", 4), ("idle", 7)):
            for _ in range(n):
                states.append(int(DeviceState.ACTIVE if phase != "idle"
                                  else DeviceState.EXECUTION_IDLE))
                sig["sm"].append(60.0 if phase != "idle" else 1.0)
                sig["dram"].append(40.0 if phase != "idle" else 0.5)
                sig["pcie"].append(5.0 if (phase == "tail" and cause == "pcie") else 0.0)
                sig["nic"].append(4.0 if (phase == "tail" and cause == "nic") else 0.0)
                sig["nvlink"].append(0.0)
                sig["cpu"].append(30.0)
    return causes, np.array(states), {k: np.array(v) for k, v in sig.items()}


def test_attribution_recovers_causes(ref):
    ref_attr, _ = ref
    causes, states, signals = cause_series(0)
    windows = extract_pre_idle_windows(states, signals, window_s=10)
    assert len(windows) == len(causes)
    result = attribute_causes(windows, min_cluster_size=8)
    assert abs(result.category_shares["pcie_heavy"] - 30 / 70) < 0.1
    assert abs(result.category_shares["nic_heavy"] - 15 / 70) < 0.1
    assert abs(result.category_shares["compute_to_idle"] - 25 / 70) < 0.1
    rwindows = ref_attr.extract_pre_idle_windows(states, signals, window_s=10)
    for w, rw in zip(windows, rwindows):
        assert (w.interval.start, w.interval.end, w.window_len_s) == \
            (rw.interval.start, rw.interval.end, rw.window_len_s)
        np.testing.assert_array_equal(w.fingerprint, rw.fingerprint)
    want = ref_attr.attribute_causes(rwindows, min_cluster_size=8)
    assert result.labels == want.labels
    assert result.category_shares == want.category_shares
    assert result.n_clusters == want.n_clusters
    assert tuple(CATEGORIES) == tuple(ref_attr.CATEGORIES)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("window_s,min_cluster_size", [(4, 5), (10, 8), (30, 20)])
def test_attribution_labels_match_reference(ref, seed, window_s, min_cluster_size):
    """Other draws, window lengths and cluster sizes: the same labels."""
    ref_attr, _ = ref
    _, states, signals = cause_series(seed)
    signals["nvlink"] = np.random.default_rng(seed).uniform(0, 1.2, states.size)
    windows = extract_pre_idle_windows(states, signals, window_s=window_s)
    rwindows = ref_attr.extract_pre_idle_windows(states, signals, window_s=window_s)
    got = attribute_causes(windows, min_cluster_size=min_cluster_size)
    want = ref_attr.attribute_causes(rwindows, min_cluster_size=min_cluster_size)
    assert (got.labels, got.category_shares, got.n_clusters) == \
        (want.labels, want.category_shares, want.n_clusters)


def test_attribution_of_no_windows(ref):
    ref_attr, _ = ref
    got = attribute_causes([])
    assert got.labels == [] and got.n_clusters == 0
    assert got.category_shares == ref_attr.attribute_causes([]).category_shares


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_clustering_labels_cover_all_points(seed):
    from repro.core.clustering import density_cluster as ref_density_cluster
    rng = np.random.default_rng(seed)
    x = np.vstack([rng.normal(0, 0.3, (40, 4)),
                   rng.normal(5, 0.3, (40, 4))])
    res = density_cluster(x, min_cluster_size=10)
    assert res.labels.shape == (80,)
    assert res.n_clusters >= 2
    first, second = res.labels[:40], res.labels[40:]
    lab1 = np.bincount(first[first >= 0]).argmax()
    lab2 = np.bincount(second[second >= 0]).argmax()
    assert lab1 != lab2
    want = ref_density_cluster(x, min_cluster_size=10)
    np.testing.assert_array_equal(res.labels, want.labels)
    assert (res.n_clusters, res.cut_scale) == (want.n_clusters, want.cut_scale)
    np.testing.assert_array_equal(res.core_distances, want.core_distances)


@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_clustering_small_inputs_match_reference(ref, n):
    _, ref_clust = ref
    x = np.random.default_rng(n).normal(size=(n, 3))
    got = density_cluster(x, min_cluster_size=2, min_samples=3,
                          standardize=n != 2)
    want = ref_clust.density_cluster(x, min_cluster_size=2, min_samples=3,
                                     standardize=n != 2)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters
    with pytest.raises(ValueError):
        density_cluster(np.zeros(3))
