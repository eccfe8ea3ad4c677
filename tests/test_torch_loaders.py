"""The port's dataset readers and fetch tool against the JAX package's, on
fixture files under ``tmp_path`` (those of ``tests/test_loaders.py``, plus
.mat graphs, fb100's pooled vocabularies, ogbn-proteins' edge features and
the papers100M subgraph): every array and every fixed split bitwise, the
node features an f32 tensor on the device asked for, and each package's
cache loaded by the other. Nothing is fetched: ``urllib`` is patched as in
``tests/test_download.py``.
"""

import gzip
import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sgformer_tpu.data import download as jdl
from sgformer_tpu.data import loaders as jl

from sgformer_tpu_torch.data import download as dl
from sgformer_tpu_torch.data import loaders as pl

torch.set_num_threads(1)


def _splits(ds, runs: int = 3):
    if ds.load_fixed_splits is None:
        return None
    try:
        return [ds.load_fixed_splits(i) for i in range(runs)]
    except TypeError:
        return [ds.load_fixed_splits()]


def _same(jds, pds):
    """The port's dataset holds the JAX one's arrays bitwise, its features
    as an f32 tensor on the CPU."""
    assert pds.name == jds.name
    assert pds.num_nodes == jds.num_nodes and pds.num_classes == jds.num_classes
    for key in ("edge_index",):
        want, got = np.asarray(jds.graph[key]), pds.graph[key]
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    feat = pds.graph["node_feat"]
    assert isinstance(feat, torch.Tensor) and feat.device.type == "cpu"
    want = np.asarray(jds.graph["node_feat"])
    assert feat.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(feat.numpy(), want)
    assert pds.label.dtype == jds.label.dtype
    np.testing.assert_array_equal(pds.label, jds.label)
    js, ps = _splits(jds), _splits(pds)
    assert (js is None) == (ps is None)
    for j, p in zip(js or [], ps or []):
        assert set(j) == set(p)
        for k in j:
            np.testing.assert_array_equal(p[k], j[k])


def _both(data_dir, name, sub=""):
    jds = jl.load_dataset(str(data_dir), name, sub)
    pds = pl.load_dataset(str(data_dir), name, sub, device="cpu")
    _same(jds, pds)
    return jds, pds


# -- fixtures ---------------------------------------------------------------


def _write_gz(path, arr, fmt):
    with gzip.open(path, "wt") as f:
        for row in np.atleast_2d(arr):
            f.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")


def _ogb(root, n=20, e=50, f=4, seed=3, split=True, year=False, edge_feat=False):
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    _write_gz(raw / "edge.csv.gz", rng.integers(0, n, (e, 2)), "%d")
    _write_gz(raw / "node-feat.csv.gz", rng.standard_normal((n, f)).astype(np.float32), "%.6f")
    _write_gz(raw / "node-label.csv.gz", rng.integers(0, 5, (n, 1)), "%d")
    if year:
        _write_gz(raw / "node_year.csv.gz", 2000 + np.arange(n) % 20, "%d")
    if edge_feat:
        _write_gz(raw / "edge-feat.csv.gz", rng.random((e, 3)).astype(np.float32), "%.5f")
    if split:
        sdir = root / "split" / "time"
        sdir.mkdir(parents=True)
        perm = rng.permutation(n)
        for name, part in zip(("train", "valid", "test"), np.split(perm, [n // 2, 3 * n // 4])):
            _write_gz(sdir / f"{name}.csv.gz", part, "%d")


def _mat(path, **arrays):
    import scipy.io as sio

    path.parent.mkdir(parents=True, exist_ok=True)
    sio.savemat(str(path), arrays)


def _sparse(n, density, seed):
    import scipy.sparse as sp

    return sp.random(n, n, density=density, format="csr", random_state=seed)


# -- OGB ----------------------------------------------------------------------


def test_ogb_csv_gz_with_split_matches_jax(tmp_path):
    _ogb(tmp_path / "ogbn_arxiv")
    jds, _ = _both(tmp_path, "ogbn-arxiv")
    assert (tmp_path / "ogbn_arxiv" / "processed.npz").exists()
    assert len(_splits(jds)[0]["train"]) == 10
    _both(tmp_path, "ogbn-arxiv")  # through the cache


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ogb_cache_written_by_one_package_loads_in_the_other(tmp_path, writer):
    _ogb(tmp_path / "ogbn_arxiv", split=False)
    first = jl if writer == "jax" else pl
    first.load_ogb(str(tmp_path), "ogbn-arxiv")
    cache = tmp_path / "ogbn_arxiv" / "processed.npz"
    assert cache.exists()
    # the raw files go: the other package can only read the cache
    for f in (tmp_path / "ogbn_arxiv" / "raw").iterdir():
        f.unlink()
    (tmp_path / "ogbn_arxiv" / "raw").rmdir()
    _both(tmp_path, "ogbn-arxiv")


def test_amazon2m_reads_products_with_random_splits(tmp_path):
    _ogb(tmp_path / "ogbn_products", n=30, e=90, seed=4)
    _, pds = _both(tmp_path, "amazon2m")
    assert pds.load_fixed_splits is None


def test_arxiv_year_quantile_labels_match_jax(tmp_path):
    _ogb(tmp_path / "ogbn_arxiv", n=30, e=40, seed=4, year=True)
    _, pds = _both(tmp_path, "arxiv-year")
    assert set(np.unique(pds.label)) <= set(range(5))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_proteins_node_features_and_their_cache_match_jax(tmp_path, writer):
    _ogb(tmp_path / "ogbn_proteins", n=25, e=80, seed=5, edge_feat=True)
    first = jl if writer == "jax" else pl
    first.load_dataset(str(tmp_path), "ogbn-proteins", **({} if writer == "jax"
                                                           else {"device": "cpu"}))
    assert (tmp_path / "ogbn_proteins" / "node_feat_mean.npy").exists()
    (tmp_path / "ogbn_proteins" / "raw" / "edge-feat.csv.gz").unlink()
    _, pds = _both(tmp_path, "ogbn-proteins")
    assert pds.graph["node_feat"].shape == (25, 3)


def test_proteins_node_features_computed_by_each_package_match(tmp_path):
    """Each package computes the mean of the incident edge features from the
    raw files itself: the two caches are bitwise the same."""
    caches = []
    for reader, kw in ((jl, {}), (pl, {"device": "cpu"})):
        root = tmp_path / reader.__name__.split(".")[0]
        _ogb(root / "ogbn_proteins", n=25, e=80, seed=5, edge_feat=True)
        reader.load_dataset(str(root), "ogbn-proteins", **kw)
        caches.append(np.load(root / "ogbn_proteins" / "node_feat_mean.npy"))
    assert caches[0].dtype == caches[1].dtype == np.float32
    np.testing.assert_array_equal(caches[1], caches[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_papers100m_sub_and_its_cache_match_jax(tmp_path, writer):
    """Each package extracts the subgraph from the raw files itself, with
    the same arrays; the cache one writes, the other reads."""
    first, other = (jl, pl) if writer == "jax" else (pl, jl)
    got = []
    for reader, root in ((first, tmp_path / "a"), (other, tmp_path / "b")):
        _ogb(root / "ogbn_papers100M", n=40, e=160, seed=6)
        got.append(reader._load_papers100m_sub(str(root), num_sub=25))
        assert (root / "ogbn_papers100M" / "sub_25.npz").exists()
    cached = other._load_papers100m_sub(str(tmp_path / "a"), num_sub=25)
    for ds in got + [cached]:
        assert ds.num_nodes == 25 and ds.graph["edge_index"].max() < 25
        for key in ("edge_index", "node_feat"):
            np.testing.assert_array_equal(ds.graph[key], got[0].graph[key])
        np.testing.assert_array_equal(ds.label, got[0].label)


def test_ogb_missing_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="offline"):
        pl.load_dataset(str(tmp_path), "ogbn-arxiv", device="cpu")


# -- npz ------------------------------------------------------------------------


def _npz_hetero(path, n=30, seed=0):
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path,
             node_features=rng.standard_normal((n, 5)).astype(np.float32),
             edges=rng.integers(0, n, (60, 2)),
             node_labels=rng.integers(0, 3, n),
             train_masks=rng.random((10, n)) < 0.5,
             val_masks=rng.random((10, n)) < 0.25,
             test_masks=rng.random((10, n)) < 0.25)


def test_npz_heterophilous_masks_match_jax(tmp_path):
    _npz_hetero(tmp_path / "roman-empire.npz")
    _, pds = _both(tmp_path, "roman-empire")
    s0, s3 = pds.load_fixed_splits(0), pds.load_fixed_splits(3)
    assert not np.array_equal(s0["train"], s3["train"])


def test_npz_heterophilous_directory_layout_matches_jax(tmp_path):
    _npz_hetero(tmp_path / "heterophilous" / "amazon_ratings.npz", seed=2)
    _both(tmp_path, "amazon-ratings")


def test_npz_planetoid_single_mask_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    n = 40
    np.savez(tmp_path / "cora.npz",
             x=np.abs(rng.standard_normal((n, 6))).astype(np.float64),
             edge_index=rng.integers(0, n, (2, 90)),
             y=rng.integers(0, 4, n),
             train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.2,
             test_mask=rng.random(n) < 0.3)
    _both(tmp_path, "cora")


def test_npz_wiki_filtered_row_normalised_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 35
    feat = rng.integers(0, 3, (n, 7)).astype(np.float64)
    feat[4] = 0.0  # a zero row keeps its zeros
    path = tmp_path / "wiki_new" / "chameleon" / "chameleon_filtered.npz"
    path.parent.mkdir(parents=True)
    np.savez(path, node_features=feat, edges=rng.integers(0, n, (80, 2)),
             node_labels=rng.integers(0, 5, n))
    _, pds = _both(tmp_path, "chameleon")
    rows = pds.graph["node_feat"].sum(1).numpy()
    assert rows[4] == 0.0


def test_npz_generic_fallback_matches_jax(tmp_path):
    _npz_hetero(tmp_path / "mygraph" / "mygraph.npz", seed=3)
    _both(tmp_path, "mygraph")


def test_npz_missing_keys_raise(tmp_path):
    np.savez(tmp_path / "bad.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="missing keys"):
        pl.load_npz_graph(str(tmp_path / "bad.npz"), "bad")


# -- .mat, fb100, twitch, geom-gcn ----------------------------------------------


def test_mat_pokec_style_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 30
    _mat(tmp_path / "pokec" / "pokec.mat", edge_index=rng.integers(0, n, (2, 70)),
         node_feat=rng.standard_normal((n, 4)), label=rng.integers(0, 2, (1, n)))
    _both(tmp_path, "pokec")


def test_mat_deezer_style_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    n = 28
    _mat(tmp_path / "deezer" / "deezer-europe.mat", A=_sparse(n, 0.15, 9),
         features=_sparse(n, 0.3, 10), label=rng.integers(0, 2, (n, 1)))
    _both(tmp_path, "deezer-europe")


def test_mat_snap_patents_years_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    n = 40
    _mat(tmp_path / "snap_patents.mat", edge_index=rng.integers(0, n, (2, 100)),
         node_feat=_sparse(n, 0.2, 12), years=1980 + rng.integers(0, 30, (1, n)))
    _, pds = _both(tmp_path, "snap-patents")
    assert set(np.unique(pds.label)) <= set(range(5))


def test_mat_yelp_chi_homo_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    n = 33
    _mat(tmp_path / "YelpChi.mat", homo=_sparse(n, 0.1, 14),
         features=rng.standard_normal((n, 5)), label=rng.integers(0, 2, (1, n)))
    _both(tmp_path, "yelp-chi")


def test_mat_generic_fallback_matches_jax(tmp_path):
    rng = np.random.default_rng(15)
    n = 21
    _mat(tmp_path / "othergraph.mat", edge_index=rng.integers(0, n, (2, 50)),
         node_feat=rng.standard_normal((n, 3)), label=rng.integers(0, 3, (1, n)))
    _both(tmp_path, "othergraph")


def _fb100_school(path, n, seed):
    rng = np.random.default_rng(seed)
    meta = np.stack([rng.integers(1, 4, n), rng.integers(1, 3, n), rng.integers(1, 5, n),
                     rng.integers(1, 3, n), rng.integers(1, 6, n)], axis=1)
    _mat(path, A=_sparse(n, 0.2, seed), local_info=meta)


@pytest.mark.parametrize("pooled", [False, True])
def test_fb100_onehot_features_match_jax(tmp_path, pooled):
    root = tmp_path / "facebook100"
    _fb100_school(root / "Penn94.mat", 25, 1)
    if pooled:  # vocabularies pooled over the schools present
        _fb100_school(root / "Amherst41.mat", 18, 2)
        _fb100_school(root / "Reed98.mat", 12, 3)
    _, pds = _both(tmp_path, "fb100", "Penn94")
    assert set(np.unique(pds.label)) <= {0, 1}


def test_twitch_csv_json_matches_jax(tmp_path):
    root = tmp_path / "twitch" / "DE"
    root.mkdir(parents=True)
    n = 12
    with open(root / "musae_DE_target.csv", "w") as f:
        f.write("id,days,mature,views,partner,new_id\n")
        for i in range(n):
            f.write(f"{i},10,{'True' if i % 2 else 'False'},5,False,{i}\n")
        f.write("0,10,True,5,False,3\n")  # a duplicate id, as FR has
    with open(root / "musae_DE_edges.csv", "w") as f:
        f.write("from,to\n")
        for i in range(n - 1):
            f.write(f"{i},{i + 1}\n")
    with open(root / "musae_DE_features.json", "w") as f:
        json.dump({str(i): [i % 7, (i * 3) % 11, 4000] for i in range(n)}, f)
    _both(tmp_path, "twitch-e", "DE")


def test_geom_gcn_txt_film_matches_jax(tmp_path):
    root = tmp_path / "geom-gcn" / "film"
    root.mkdir(parents=True)
    n = 8
    with open(root / "out1_node_feature_label.txt", "w") as f:
        f.write("id\tfeat\tlabel\n")
        for i in range(n):
            f.write(f"{i}\t{i},{i + 1}\t{i % 3}\n")
    with open(root / "out1_graph_edges.txt", "w") as f:
        f.write("src\tdst\n")
        for i in range(n - 1):
            f.write(f"{i}\t{i + 1}\n")
    rng = np.random.default_rng(0)
    for k in range(2):
        np.savez(root / f"film_split_0.6_0.2_{k}.npz", train_mask=rng.random(n) < 0.6,
                 val_mask=rng.random(n) < 0.2, test_mask=rng.random(n) < 0.2)
    _, pds = _both(tmp_path, "film")
    assert pds.graph["node_feat"].shape == (n, 932)


def test_unknown_dataset_raises(tmp_path):
    with pytest.raises(ValueError, match="Unknown dataset"):
        pl.load_dataset(str(tmp_path), "no-such-graph", device="cpu")


# -- synthetic names and the device ---------------------------------------------


@pytest.mark.parametrize("name", ["synth", "synth-small", "synth-n300-e2400-f16-c4",
                                  "synth-n120-e500-f8-c3-s7", "synth-n:90-e:300-c:5"])
def test_synth_names_match_jax(name):
    _both("", name)


def test_load_dataset_places_features_and_refuses_without_cuda(tmp_path, monkeypatch):
    _npz_hetero(tmp_path / "roman-empire.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("roman-empire", "synth-small"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pl.load_dataset(str(tmp_path), name)


# -- the fetch tool (tests/test_download.py's cases) -----------------------------


def test_download_registry_is_the_jax_one():
    assert dl.DRIVE_FILES == jdl.DRIVE_FILES and dl.DRIVE_SPLITS == jdl.DRIVE_SPLITS
    assert dl._DRIVE_URL == jdl._DRIVE_URL


def test_download_registry_matches_loader_paths(tmp_path):
    """A sentinel at each registry path is found by the port's
    ``load_dataset`` (which then fails parsing it, not finding it)."""
    for name, files in dl.DRIVE_FILES.items():
        data_dir = tmp_path / name
        for rel in files:
            dest = data_dir / rel
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(b"not a mat file")
        try:
            pl.load_dataset(str(data_dir), name, device="cpu")
        except FileNotFoundError as e:  # pragma: no cover - failure path
            raise AssertionError(f"{name!r}: registry paths {sorted(files)} not read: {e}")
        except Exception:
            pass


def test_download_keeps_existing_files(tmp_path):
    dest = tmp_path / "pokec" / "pokec.mat"
    dest.parent.mkdir(parents=True)
    dest.write_bytes(b"sentinel")
    assert dl.fetch_dataset("pokec", str(tmp_path)) == []
    assert dest.read_bytes() == b"sentinel"


def test_download_unknown_dataset_raises_keyerror(tmp_path):
    with pytest.raises(KeyError, match="ogb"):
        dl.fetch_dataset("ogbn-arxiv", str(tmp_path))


def test_download_offline_error_names_manual_path(tmp_path, monkeypatch):
    def no_net(*a, **k):
        raise urllib.error.URLError(OSError("no egress"))

    monkeypatch.setattr(urllib.request, "urlopen", no_net)
    dest = os.path.join(str(tmp_path), "snap_patents.mat")
    with pytest.raises(ConnectionError) as e:
        dl.drive_fetch("1ldh23TSY1PwXia6dU0MYcpyEgX-w3Hia", dest)
    msg = str(e.value)
    assert dest in msg and "drive.google.com" in msg
    assert not os.path.exists(dest + ".part")


def test_download_cli_offline_exits_nonzero(tmp_path, monkeypatch):
    def no_net(*a, **k):
        raise OSError("no egress")

    monkeypatch.setattr(urllib.request, "urlopen", no_net)
    assert dl.main(["yelp-chi", "--data_dir", str(tmp_path)]) == 1


class _FakeResponse(io.BytesIO):
    def __init__(self, body: bytes, ctype: str):
        super().__init__(body)
        self.headers = {"Content-Type": ctype}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_download_html_error_page_rejected(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: _FakeResponse(
        b"<!DOCTYPE html><html>Quota exceeded</html>", "text/html; charset=utf-8"))
    dest = os.path.join(str(tmp_path), "YelpChi.mat")
    with pytest.raises(ConnectionError, match="HTML"):
        dl.drive_fetch("x", dest)
    assert not os.path.exists(dest) and not os.path.exists(dest + ".part")


def test_download_writes_the_payload(tmp_path, monkeypatch):
    body = bytes(range(256)) * 5000  # more than one 1 MiB read
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda *a, **k: _FakeResponse(body, "application/octet-stream"))
    written = dl.fetch_dataset("yelp-chi", str(tmp_path))
    assert written == [os.path.join(str(tmp_path), "YelpChi.mat")]
    with open(written[0], "rb") as f:
        assert f.read() == body
