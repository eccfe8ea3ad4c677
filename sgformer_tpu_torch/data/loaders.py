"""Dataset loaders: the port of ``sgformer_tpu/data/loaders.py``.

Every reader reads files already on disk under ``data_dir`` and returns the
JAX package's numpy arrays from the same files; none downloads (fetching is
the explicit ``python -m sgformer_tpu_torch.data.download``). The formats:

- **OGB node-prediction directories** (``ogbn_arxiv/``, ``ogbn_products/``,
  ``ogbn_proteins/``, ``ogbn_papers100M/``): ``raw/*.csv.gz``, cached as
  ``processed.npz``, with the ``split/<kind>/{train,valid,test}.csv.gz``
  split; the papers100M subgraph cache ``sub_1000000.npz`` and
  ogbn-proteins' ``node_feat_mean.npy``. The caches keep the JAX package's
  names and formats, so a cache either package writes loads in the other.
- **npz** graphs (planetoid, heterophilous, wiki-filtered), **.mat**
  graphs (pokec, deezer-europe, snap-patents, yelp-chi), fb100, twitch
  (musae csv/json) and geom-gcn txt, through numpy and scipy.
- ``synth*`` names: :func:`synthetic_dataset` (numpy ``default_rng``, so
  the same seed gives the JAX package's arrays).

``load_dataset(data_dir, name, sub_dataset, device=...)`` is the entry
point. The readers leave every array on the host; ``load_dataset`` places
the node features, which the model reads, on ``device`` after any host
transform, as :func:`synthetic_dataset` does. The edge list and the labels
stay numpy arrays: ``preprocess_graph`` moves the edge list to its own
``device``, and the splits are drawn on the host.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np
import torch

from sgformer_tpu_torch.data.ncdataset import NCDataset
from sgformer_tpu_torch.data.splits import even_quantile_labels, masks_to_idx
from sgformer_tpu_torch.device import resolve_device

# named shapes; synth-arxiv has ogbn-arxiv's node and directed-edge counts,
# feature width and class count
SYNTHETIC = {
    "synth-arxiv": dict(
        num_nodes=169_343, num_edges=1_166_243, num_features=128, num_classes=40
    ),
}


def synthetic_dataset(
    name: str | None = None,
    *,
    num_nodes: int = 2708,
    num_edges: int = 10556,
    num_features: int = 128,
    num_classes: int = 7,
    seed: int = 0,
    homophily: float = 0.8,
    powerlaw: float = 0.0,
    feature_scale: float = 2.0,
    device="cuda",
) -> NCDataset:
    """Planted-partition graph with class-correlated features.

    ``name`` picks a shape from :data:`SYNTHETIC` in place of ``num_nodes``,
    ``num_edges``, ``num_features`` and ``num_classes``. With probability
    ``homophily`` an edge joins two nodes of one class; ``powerlaw`` > 0
    draws sources from a shuffled Zipf popularity; ``feature_scale`` sets the
    class-centre separation against unit noise.
    """
    dev = resolve_device(device)
    if name is not None:
        if name not in SYNTHETIC:
            raise ValueError(f"unknown synthetic dataset {name!r}; known: {sorted(SYNTHETIC)}")
        shape = SYNTHETIC[name]
        num_nodes, num_edges = shape["num_nodes"], shape["num_edges"]
        num_features, num_classes = shape["num_features"], shape["num_classes"]
    rng = np.random.default_rng(seed)
    label = rng.integers(0, num_classes, num_nodes)
    centers = rng.standard_normal((num_classes, num_features)) * feature_scale
    feat = centers[label] + rng.standard_normal((num_nodes, num_features))
    if powerlaw > 0.0:
        pop = (np.arange(1, num_nodes + 1, dtype=np.float64) + 10.0) ** (-powerlaw)
        pop = rng.permutation(pop / pop.sum())
        src = rng.choice(num_nodes, size=num_edges, p=pop)
    else:
        src = rng.integers(0, num_nodes, num_edges)
    same = rng.random(num_edges) < homophily
    order = np.argsort(label, kind="stable")
    class_starts = np.searchsorted(label[order], np.arange(num_classes))
    class_ends = np.searchsorted(label[order], np.arange(num_classes), side="right")
    ls, le = class_starts[label[src]], class_ends[label[src]]
    dst_same = order[(ls + (rng.random(num_edges) * (le - ls)).astype(np.int64))]
    dst_rand = rng.integers(0, num_nodes, num_edges)
    dst = np.where(same, dst_same, dst_rand)

    ds = NCDataset(name or f"synth-n{num_nodes}")
    ds.graph = {
        "edge_index": np.stack([src, dst]).astype(np.int64),
        "node_feat": torch.from_numpy(feat.astype(np.float32)).to(dev),
        "edge_feat": None,
        "num_nodes": num_nodes,
    }
    ds.label = label.reshape(-1, 1).astype(np.int64)
    return ds


def _parse_synth_name(name: str, device="cuda") -> NCDataset:
    """synth, synth-small, synth-arxiv, or synth-n<N>-e<E>-f<F>-c<C>[-s<S>]."""
    if name == "synth":
        return synthetic_dataset(device=device)
    if name == "synth-small":
        return synthetic_dataset(num_nodes=200, num_edges=800, num_features=32, device=device)
    if name in SYNTHETIC:
        return synthetic_dataset(**SYNTHETIC[name], device=device)
    parts = dict(
        p.split(":", 1) if ":" in p else (p[0], p[1:])
        for p in name.split("-")[1:]
    )
    return synthetic_dataset(
        num_nodes=int(parts.get("n", 2708)),
        num_edges=int(parts.get("e", 10556)),
        num_features=int(parts.get("f", 128)),
        num_classes=int(parts.get("c", 7)),
        seed=int(parts.get("s", 0)),
        device=device,
    )


# ---------------------------------------------------------------------------
# OGB (extracted directory layout)
# ---------------------------------------------------------------------------


def _read_csv_gz_ints(path: Path, dtype=np.int64) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _read_csv_gz_floats(path: Path) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=np.float32, ndmin=2)


def load_ogb(data_dir: str, name: str) -> NCDataset:
    """Load an extracted OGB node-prediction dataset.  Prefers a cached
    ``processed.npz``; otherwise parses the ``raw/*.csv.gz`` layout and
    writes the cache."""
    dir_name = name.replace("-", "_")
    root = Path(data_dir) / dir_name
    cache = root / "processed.npz"
    ds = NCDataset(name)
    if cache.exists():
        z = np.load(cache, allow_pickle=False)
        edge_index, node_feat, label = z["edge_index"], z["node_feat"], z["label"]
        num_nodes = int(z["num_nodes"])
    else:
        raw = root / "raw"
        if not raw.exists():
            raise FileNotFoundError(
                f"{name}: expected {cache} or {raw} (offline loader; "
                "download + extract the OGB zip first)"
            )
        edge_index = _read_csv_gz_ints(raw / "edge.csv.gz").T
        node_feat = _read_csv_gz_floats(raw / "node-feat.csv.gz")
        label = _read_csv_gz_floats(raw / "node-label.csv.gz")
        num_nodes = node_feat.shape[0]
        np.savez_compressed(
            cache,
            edge_index=edge_index,
            node_feat=node_feat,
            label=label,
            num_nodes=num_nodes,
        )
    ds.graph = {
        "edge_index": edge_index.astype(np.int64),
        "node_feat": node_feat.astype(np.float32),
        "edge_feat": None,
        "num_nodes": num_nodes,
    }
    ds.label = label.astype(np.int64).reshape(num_nodes, -1)

    split_dir = root / "split"
    if split_dir.exists():
        # standard OGB split csvs (time/ or sales_ranking/ etc.)
        sub = next(split_dir.iterdir())

        def fixed():
            return {
                k: _read_csv_gz_ints(sub / f"{v}.csv.gz").reshape(-1)
                for k, v in (("train", "train"), ("valid", "valid"), ("test", "test"))
            }

        ds.load_fixed_splits = fixed
    return ds


# ---------------------------------------------------------------------------
# npz formats (planetoid / heterophilous / wiki-filtered)
# ---------------------------------------------------------------------------


def load_npz_graph(path: str, name: str, undirected_hint: bool = True,
                   row_normalize: bool = False) -> NCDataset:
    """Generic npz loader covering the geom-gcn planetoid exports, the
    heterophilous-graph suite, and the filtered wiki datasets
    (``medium/dataset.py:214-305``).  Expects keys
    ``node_features|features|x``, ``edges|edge_index``, ``node_labels|y|label``
    and optional ``train_masks/val_masks/test_masks``.  ``row_normalize``
    applies the reference's ``normalize_feat`` row normalization — the
    wiki-filtered loader does this by default
    (``medium/dataset.py:241-250``)."""
    z = np.load(path, allow_pickle=True)

    def pick(*keys):
        for k in keys:
            if k in z:
                return z[k]
        return None

    feat = pick("node_features", "features", "x")
    edges = pick("edges", "edge_index")
    label = pick("node_labels", "y", "label", "labels")
    if feat is None or edges is None or label is None:
        raise ValueError(f"{path}: missing keys, found {list(z.keys())}")
    if edges.shape[0] != 2:
        edges = edges.T
    if row_normalize:
        feat = feat.astype(np.float64)
        rowsum = feat.sum(axis=1)
        with np.errstate(divide="ignore"):
            r_inv = 1.0 / rowsum
        r_inv[~np.isfinite(r_inv)] = 0.0
        feat = feat * r_inv[:, None]
    ds = NCDataset(name)
    n = feat.shape[0]
    ds.graph = {
        "edge_index": edges.astype(np.int64),
        "node_feat": feat.astype(np.float32),
        "edge_feat": None,
        "num_nodes": n,
    }
    ds.label = label.astype(np.int64).reshape(n, -1)

    if "train_masks" in z:  # heterophilous 10-mask rotation
        tm, vm, sm = z["train_masks"], z["val_masks"], z["test_masks"]

        def fixed(i=0):
            return masks_to_idx(
                {"train": tm[i % len(tm)], "valid": vm[i % len(vm)], "test": sm[i % len(sm)]}
            )

        ds.load_fixed_splits = fixed
    elif "train_mask" in z:

        def fixed(i=0):
            return masks_to_idx(
                {"train": z["train_mask"], "valid": z["val_mask"], "test": z["test_mask"]}
            )

        ds.load_fixed_splits = fixed
    return ds


# ---------------------------------------------------------------------------
# .mat graphs (pokec / fb100 / deezer-europe)
# ---------------------------------------------------------------------------


def load_mat_graph(path: str, name: str) -> NCDataset:
    import scipy.io as sio
    import scipy.sparse as sp

    mat = sio.loadmat(path)
    ds = NCDataset(name)
    if "A" in mat or "homo" in mat:
        # deezer style: A + features + label (dataset.py:242-260);
        # yelp-chi style: homo adjacency + features + label
        # (dataset.py:446-466)
        a = sp.csr_matrix(mat["A"] if "A" in mat else mat["homo"]).tocoo()
        edge_index = np.stack([a.row, a.col]).astype(np.int64)
        feat = mat.get("features")
        label = mat.get("label", mat.get("local_info"))
    else:
        # pokec / snap-patents style: edge_index + node_feat arrays
        # (dataset.py:371-397, 419-444); snap-patents carries grant
        # 'years' instead of a label column
        edge_index = np.asarray(mat["edge_index"], dtype=np.int64)
        feat = mat["node_feat"]
        label = mat["label"] if "label" in mat else mat["years"]
    feat = np.asarray(
        feat.todense() if hasattr(feat, "todense") else feat, dtype=np.float32
    )
    n = feat.shape[0]
    ds.graph = {
        "edge_index": edge_index,
        "node_feat": feat,
        "edge_feat": None,
        "num_nodes": n,
    }
    ds.label = np.asarray(label).reshape(n, -1).astype(np.int64)
    return ds


def load_fb100(data_dir: str, filename: str = "Penn94") -> NCDataset:
    """fb100: gender labels, one-hot features with vocabularies pooled over
    five schools (``large/dataset.py:201-240``).  Missing schools fall back
    to the target school's own vocabularies."""
    import scipy.io as sio

    root = Path(data_dir) / "facebook100"

    def _feats(mat):
        meta = np.asarray(mat["local_info"]).astype(np.int64)
        return np.hstack([meta[:, 0:1], meta[:, 2:]])

    target = sio.loadmat(str(root / f"{filename}.mat"))
    pool = []
    for f in ("Penn94", "Amherst41", "Cornell5", "Johns Hopkins55", "Reed98"):
        p = root / f"{f}.mat"
        if p.exists():
            pool.append(_feats(sio.loadmat(str(p))))
    pool = np.vstack(pool) if pool else _feats(target)

    import scipy.sparse as sp

    a = sp.csr_matrix(target["A"]).tocoo()
    meta = np.asarray(target["local_info"]).astype(np.int64)
    label = meta[:, 1] - 1  # gender; -1 = unlabeled
    label = np.where(label > 0, 1, 0)
    fv = _feats(target)
    cols = []
    for c in range(fv.shape[1]):
        classes = np.unique(pool[:, c])
        if len(classes) == 2:
            # sklearn label_binarize's binary special case (the reference
            # encoder, large/dataset.py:225-230): ONE 0/1 column marking
            # the larger class — not a two-column one-hot
            onehot = (fv[:, c:c + 1] == classes[1]).astype(np.float32)
        else:
            onehot = (fv[:, c:c + 1] == classes[None, :]).astype(np.float32)
        cols.append(onehot)
    features = np.hstack(cols)

    ds = NCDataset(f"fb100-{filename}")
    ds.graph = {
        "edge_index": np.stack([a.row, a.col]).astype(np.int64),
        "node_feat": features,
        "edge_feat": None,
        "num_nodes": meta.shape[0],
    }
    ds.label = label.reshape(-1, 1).astype(np.int64)
    return ds


def load_twitch(data_dir: str, lang: str = "DE") -> NCDataset:
    """twitch-e: mature-content labels from musae csv/json raw files
    (``large/dataset.py:140-175``, ``large/load_data.py:21-60``)."""
    import csv
    import json

    assert lang in ("DE", "ENGB", "ES", "FR", "PTBR", "RU", "TW")
    root = Path(data_dir) / "twitch" / lang
    label, node_ids, uniq = [], [], set()
    with open(root / f"musae_{lang}_target.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            nid = int(row[5])
            if nid not in uniq:  # FR has duplicate rows
                uniq.add(nid)
                label.append(int(row[2] == "True"))
                node_ids.append(nid)
    src, dst = [], []
    with open(root / f"musae_{lang}_edges.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            src.append(int(row[0]))
            dst.append(int(row[1]))
    with open(root / f"musae_{lang}_features.json") as f:
        feat_json = json.load(f)
    n = len(label)
    dim = 3170  # musae feature vocabulary size (reference convention)
    features = np.zeros((n, dim), dtype=np.float32)
    for k, vals in feat_json.items():
        idx = [v for v in vals if v < dim]
        features[int(k), idx] = 1.0
    ds = NCDataset("twitch-e")
    ds.graph = {
        "edge_index": np.stack(
            [np.asarray(src), np.asarray(dst)]
        ).astype(np.int64),
        "node_feat": features,
        "edge_feat": None,
        "num_nodes": n,
    }
    ds.label = np.asarray(label).reshape(-1, 1).astype(np.int64)
    return ds


def load_geom_gcn(data_dir: str, name: str) -> NCDataset:
    """geom-gcn raw txt graphs (``medium/dataset.py:153-213``): film stores
    sparse one-hot feature indices (932-dim), others dense vectors."""
    root = Path(data_dir) / "geom-gcn" / name
    feats, labels = {}, {}
    with open(root / "out1_node_feature_label.txt") as f:
        f.readline()
        for line in f:
            nid, feat, lab = line.rstrip().split("\t")
            if name == "film":
                blank = np.zeros(932, dtype=np.float32)
                blank[np.asarray(feat.split(","), dtype=np.int64)] = 1.0
                feats[int(nid)] = blank
            else:
                feats[int(nid)] = np.asarray(feat.split(","), dtype=np.float32)
            labels[int(nid)] = int(lab)
    src, dst = [], []
    with open(root / "out1_graph_edges.txt") as f:
        f.readline()
        for line in f:
            a, b = line.rstrip().split("\t")
            src.append(int(a))
            dst.append(int(b))
    n = max(feats) + 1
    x = np.stack([feats[i] for i in range(n)]).astype(np.float64)
    # the reference ROW-NORMALIZES features (preprocess_features with a
    # zero-rowsum → 1 guard, medium/dataset.py:214-224) and returns the
    # adjacency PLUS the identity (adj + eye, medium/dataset.py:206-208)
    rowsum = x.sum(axis=1)
    rowsum = np.where(rowsum == 0, 1.0, rowsum)
    x = (x / rowsum[:, None]).astype(np.float32)
    y = np.asarray([labels[i] for i in range(n)], dtype=np.int64)
    src = np.concatenate([np.asarray(src), np.arange(n)])
    dst = np.concatenate([np.asarray(dst), np.arange(n)])
    ds = NCDataset(name)
    ds.graph = {
        "edge_index": np.stack([src, dst]).astype(np.int64),
        "node_feat": x,
        "edge_feat": None,
        "num_nodes": n,
    }
    ds.label = y.reshape(-1, 1)
    # geom-gcn ships 10 fixed split npz masks alongside
    split_files = sorted((Path(data_dir) / "geom-gcn" / name).glob(
        f"{name}_split_0.6_0.2_*.npz"
    ))
    if split_files:

        def fixed(i=0):
            z = np.load(split_files[i % len(split_files)])
            return masks_to_idx({
                "train": z["train_mask"], "valid": z["val_mask"],
                "test": z["test_mask"],
            })

        ds.load_fixed_splits = fixed
    return ds


# ---------------------------------------------------------------------------
# Registry / entry point
# ---------------------------------------------------------------------------

_OGB_NAMES = {
    "ogbn-arxiv",
    "ogbn-products",
    "ogbn-proteins",
    "ogbn-papers100M",
    "amazon2m",  # = ogbn-products graph with 50/25/25 random split
}

_NPZ_NAMES = {
    "cora",
    "citeseer",
    "pubmed",
    "chameleon",
    "squirrel",
    "film",
    "roman-empire",
    "amazon-ratings",
    "minesweeper",
    "tolokers",
    "questions",
}

_MAT_NAMES = {"pokec", "deezer-europe", "fb100"}


def load_dataset(data_dir: str, name: str, sub_dataset: str = "", *,
                 device="cuda") -> NCDataset:
    """Entry point mirroring ``large/dataset.py:89-137``: the JAX package's
    dataset, its node features an f32 tensor on ``device`` ("cuda" unless
    the caller asks for the CPU), placed after the reader's host
    transforms."""
    dev = resolve_device(device)
    if name.startswith("synth"):
        return _parse_synth_name(name, device=dev)
    ds = _read(data_dir, name, sub_dataset)
    feat = np.ascontiguousarray(ds.graph["node_feat"], dtype=np.float32)
    ds.graph["node_feat"] = torch.from_numpy(feat).to(dev)
    return ds


def _read(data_dir: str, name: str, sub_dataset: str) -> NCDataset:
    """The reader of ``name``; every array stays on the host."""
    if name in _OGB_NAMES:
        ogb_name = "ogbn-products" if name == "amazon2m" else name
        ds = load_ogb(data_dir, ogb_name)
        ds.name = name
        if name == "amazon2m":
            ds.load_fixed_splits = None  # uses 50/25/25 random splits
        if name == "ogbn-proteins":
            _proteins_node_feats(data_dir, ds)
        return ds
    if name in _NPZ_NAMES:
        for candidate in (
            Path(data_dir) / f"{name}.npz",
            Path(data_dir) / name / f"{name}.npz",
            Path(data_dir) / "heterophilous" / f"{name.replace('-', '_')}.npz",
            Path(data_dir) / "wiki_new" / name / f"{name}_filtered.npz",
        ):
            if candidate.exists():
                # the wiki-filtered loader row-normalizes features
                # (medium/dataset.py:241-250); the heterophilous one
                # doesn't (medium/dataset.py:269-305)
                return load_npz_graph(
                    str(candidate), name,
                    row_normalize="wiki_new" in str(candidate),
                )
        # geom-gcn raw txt fallback (film; medium/dataset.py:153-213)
        if (Path(data_dir) / "geom-gcn" / name).exists():
            return load_geom_gcn(data_dir, name)
        raise FileNotFoundError(f"{name}: no npz found under {data_dir}")
    if name == "fb100":
        # dedicated loader: gender labels + pooled-vocabulary one-hot
        # features with sklearn's binary special case (dataset.py:201-240)
        return load_fb100(data_dir, sub_dataset or "Penn94")
    if name in _MAT_NAMES:
        fname = name.replace("-", "_")
        candidates = [
            Path(data_dir) / f"{fname}.mat",
            Path(data_dir) / name / f"{fname}.mat",
        ]
        if name == "deezer-europe":
            # the reference stores it as deezer/deezer-europe.mat
            # (dataset.py:246)
            candidates += [
                Path(data_dir) / "deezer" / "deezer-europe.mat",
                Path(data_dir) / "deezer-europe.mat",
            ]
        if name == "pokec":
            candidates.append(Path(data_dir) / "pokec" / "pokec.mat")
        for candidate in candidates:
            if candidate.exists():
                return load_mat_graph(str(candidate), name)
        raise FileNotFoundError(f"{name}: no .mat found under {data_dir}")
    if name == "arxiv-year":
        ds = load_ogb(data_dir, "ogbn-arxiv")
        ds.name = name
        # label = publication-year quantile buckets (large/dataset.py:162-171);
        # years come from the node_year raw column
        year_path = Path(data_dir) / "ogbn_arxiv" / "raw" / "node_year.csv.gz"
        if year_path.exists():
            years = _read_csv_gz_ints(year_path).reshape(-1).astype(np.float64)
        else:
            years = ds.label.reshape(-1).astype(np.float64)
        ds.label = even_quantile_labels(years, 5).reshape(-1, 1)
        ds.load_fixed_splits = None
        return ds
    if name == "snap-patents":
        ds = _load_mat_any(data_dir, "snap_patents", name)
        # label = grant-year quantile buckets (large/dataset.py:176-186)
        years = ds.label.reshape(-1).astype(np.float64)
        ds.label = even_quantile_labels(years, 5).reshape(-1, 1)
        return ds
    if name == "yelp-chi":
        return _load_mat_any(data_dir, "YelpChi", name)
    if name == "twitch-e":
        # raw musae csv/json files, as the reference reads them
        # (dataset.py:140-200)
        lang = sub_dataset or "DE"
        if (Path(data_dir) / "twitch" / lang).exists():
            return load_twitch(data_dir, lang)
        return _load_mat_any(data_dir, f"twitch_{lang}", name)
    if name == "ogbn-papers100M-sub":
        return _load_papers100m_sub(data_dir)
    # generic fallback: try npz then mat with the dataset's own name
    for candidate in (
        Path(data_dir) / f"{name}.npz",
        Path(data_dir) / name / f"{name}.npz",
    ):
        if candidate.exists():
            return load_npz_graph(str(candidate), name)
    for candidate in (
        Path(data_dir) / f"{name}.mat",
        Path(data_dir) / name / f"{name}.mat",
    ):
        if candidate.exists():
            return load_mat_graph(str(candidate), name)
    raise ValueError(f"Unknown dataset: {name}")


def _load_mat_any(data_dir: str, fname: str, name: str) -> NCDataset:
    for candidate in (
        Path(data_dir) / f"{fname}.mat",
        Path(data_dir) / name / f"{fname}.mat",
    ):
        if candidate.exists():
            return load_mat_graph(str(candidate), name)
    raise FileNotFoundError(f"{name}: no {fname}.mat under {data_dir}")


def _load_papers100m_sub(data_dir: str, num_sub: int = 1_000_000) -> NCDataset:
    """First-``num_sub``-node cached subgraph of ogbn-papers100M
    (``large/dataset.py:628-698``): keeps edges with both endpoints below
    the cutoff, persists the extraction so later runs load instantly."""
    root = Path(data_dir) / "ogbn_papers100M"
    cache = root / f"sub_{num_sub}.npz"
    ds = NCDataset("ogbn-papers100M-sub")
    if cache.exists():
        z = np.load(cache)
        ds.graph = {
            "edge_index": z["edge_index"],
            "node_feat": z["node_feat"],
            "edge_feat": None,
            "num_nodes": int(z["num_nodes"]),
        }
        ds.label = z["label"]
        return ds
    full = load_ogb(data_dir, "ogbn-papers100M")
    e = full.graph["edge_index"]
    mask = (e[0] < num_sub) & (e[1] < num_sub)
    sub_e = e[:, mask]
    ds.graph = {
        "edge_index": sub_e,
        "node_feat": full.graph["node_feat"][:num_sub],
        "edge_feat": None,
        "num_nodes": num_sub,
    }
    ds.label = full.label[:num_sub]
    np.savez_compressed(
        cache, edge_index=sub_e, node_feat=ds.graph["node_feat"],
        label=ds.label, num_nodes=num_sub,
    )
    return ds


def _proteins_node_feats(data_dir: str, ds: NCDataset) -> None:
    """ogbn-proteins has edge features only; node feature = mean of incident
    edge features (``large/dataset.py:331-351``)."""
    root = Path(data_dir) / "ogbn_proteins"
    ef_path = root / "raw" / "edge-feat.csv.gz"
    cache = root / "node_feat_mean.npy"
    if cache.exists():
        ds.graph["node_feat"] = np.load(cache)
        return
    if not ef_path.exists():
        return
    edge_feat = _read_csv_gz_floats(ef_path)
    n = ds.graph["num_nodes"]
    src = ds.graph["edge_index"][0]
    total = np.zeros((n, edge_feat.shape[1]), dtype=np.float64)
    np.add.at(total, src, edge_feat)
    count = np.bincount(src, minlength=n).astype(np.float64)
    feat = (total / np.maximum(count, 1.0)[:, None]).astype(np.float32)
    np.save(cache, feat)
    ds.graph["node_feat"] = feat
