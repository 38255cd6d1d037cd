"""The port's data pipeline against the JAX package's: the paper's
synthetic key distributions, the packed token store's files, its tuned
sample index and its reads, on the same numpy-seeded records.  Exact
throughout: the store is host code in both packages, and both rank
AirTune's candidates in numpy."""
import itertools
import os

import numpy as np
import pytest

from repro.data import DATASETS as J_DATASETS
from repro.data import ShardedTokenStore as JStore
from repro.data import sosd_like as j_sosd_like
from repro.data import write_token_store as j_write
from repro_torch.data import DATASETS, ShardedTokenStore, sosd_like
from repro_torch.data import write_token_store

STORE_FILES = ("shard0.tokens", "offsets.npy", "manifest.json")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _samples(n, seed, vocab=1000, lengths=(20, 300)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(*lengths)).astype(np.int32)
            for _ in range(n)]


def test_dataset_names_equal_the_references():
    assert DATASETS == J_DATASETS


@pytest.mark.parametrize("name", [*J_DATASETS, "uden64"])
@pytest.mark.parametrize("seed", [0, 5])
def test_sosd_like_equals_the_reference_in_one_process(name, seed):
    got, want = sosd_like(name, 20_000, seed), j_sosd_like(name, 20_000, seed)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_sosd_like_rejects_an_unknown_name_as_the_reference():
    for fn in (sosd_like, j_sosd_like):
        with pytest.raises(ValueError):
            fn("tape", 10)


# (records, seed): a one-layer index, a wider one, records of one token
STORES = [(500, 0), (3000, 1), (64, 2)]


@pytest.fixture(scope="module", params=STORES, ids=lambda p: f"n{p[0]}")
def stores(request, tmp_path_factory):
    n, seed = request.param
    samples = _samples(n, seed, lengths=(1, 2) if n == 64 else (20, 300))
    root = tmp_path_factory.mktemp(f"store{n}")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jman, tman = j_write(jdir, samples), write_token_store(tdir, samples)
    js = JStore(jdir, profile="azure_ssd")
    ts = ShardedTokenStore(tdir, profile="azure_ssd")
    yield samples, (jdir, jman, js), (tdir, tman, ts)
    js.close()
    ts.close()


def test_written_store_files_are_byte_identical(stores):
    _, (jdir, jman, _), (tdir, tman, _) = stores
    assert tman == jman
    for name in STORE_FILES:
        assert _read(os.path.join(tdir, name)) == \
            _read(os.path.join(jdir, name)), name


def test_sample_index_design_cost_and_file_equal_the_references(stores):
    _, (jdir, _, js), (tdir, _, ts) = stores
    assert ts.n == js.n
    assert ts.tune.design.describe() == js.tune.design.describe()
    assert ts.tune.cost == js.tune.cost
    assert _read(os.path.join(tdir, "sample.air")) == \
        _read(os.path.join(jdir, "sample.air"))
    np.testing.assert_array_equal(ts.offs, js.offs)


def test_gets_equal_the_records_and_the_references(stores):
    samples, (_, _, js), (_, _, ts) = stores
    ids = np.random.default_rng(9).integers(0, len(samples), 200)
    before = [(s.index.bytes_read, s.index.reads) for s in (js, ts)]
    for i in (*ids, 0, len(samples) - 1):
        got = ts.get(int(i))
        np.testing.assert_array_equal(got, js.get(int(i)))
        np.testing.assert_array_equal(got, samples[int(i)])
    # the same partial reads of the index
    (jb, jr), (tb, tr) = before
    assert (ts.index.bytes_read - tb, ts.index.reads - tr) == \
        (js.index.bytes_read - jb, js.index.reads - jr)


@pytest.mark.parametrize("start_step", [0, 3])
def test_batch_iterator_equals_the_references(stores, start_step):
    _, (_, _, js), (_, _, ts) = stores
    got = list(itertools.islice(
        ts.batch_iterator(4, 64, seed=7, start_step=start_step), 4))
    want = list(itertools.islice(
        js.batch_iterator(4, 64, seed=7, start_step=start_step), 4))
    for g, w in zip(got, want):
        assert set(g) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            assert g[k].shape == (4, 64)
            np.testing.assert_array_equal(g[k], w[k])


def test_batch_iterator_replays_from_any_step(stores):
    _, _, (_, _, ts) = stores
    run = list(itertools.islice(ts.batch_iterator(2, 32, seed=1), 5))
    for step in (1, 4):
        again = next(ts.batch_iterator(2, 32, seed=1, start_step=step))
        np.testing.assert_array_equal(again["tokens"], run[step]["tokens"])
        np.testing.assert_array_equal(again["labels"], run[step]["labels"])
