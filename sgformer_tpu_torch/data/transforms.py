"""Feature / adjacency transforms, host numpy and scipy: the port of
``sgformer_tpu/data/transforms.py``, with the same results.

The JAX module covers the reference's utility-transform surface (SURVEY.md §2.3):
feature augmentation for the heterophilous suite
(the SGFormer reference's ``medium/dataset.py:306-351``), planetoid row
normalization (PyG ``NormalizeFeatures`` used at
``medium/dataset.py:124-129``), the DAD/DA/AD normalized-adjacency trio
(``large/data_utils.py:173-197``), sparse adjacency powers for NodeFormer
(``large/data_utils.py:255-260``) and the dense adjacency materializer
(``large/data_utils.py:248-253``). The two edge-list helpers it takes from
the JAX package's ``graph`` module are numpy copies here (the port's
``graph`` module works on tensors)."""

from __future__ import annotations

import numpy as np
import torch


def remove_self_loops(edge_index: np.ndarray) -> np.ndarray:
    src, dst = edge_index
    mask = src != dst
    return np.stack([src[mask], dst[mask]])


def add_self_loops(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    loop = np.arange(num_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loop, loop])], axis=1)


def normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-normalize to sum 1 (PyG ``T.NormalizeFeatures``)."""
    x = np.asarray(x, dtype=np.float32)
    s = x.sum(axis=1, keepdims=True)
    return x / np.maximum(s, 1e-12)


def compute_sgc_features(
    edge_index: np.ndarray, node_features: np.ndarray, num_props: int = 5
) -> np.ndarray:
    """K-step DAD propagation of the features (``medium/dataset.py:306-320``):
    self-loops added, coefficients 1/sqrt(d_row · d_col), aggregate col→row."""
    n = node_features.shape[0]
    e = remove_self_loops(np.asarray(edge_index))
    e = add_self_loops(e, n)
    row, col = e
    deg = np.bincount(row, minlength=n).astype(np.float64)
    prod = deg[row] * deg[col]
    coef = 1.0 / np.sqrt(np.maximum(prod, 1.0))
    x = np.asarray(node_features, dtype=np.float64)
    for _ in range(num_props):
        msgs = coef[:, None] * x[col]
        out = np.zeros_like(x)
        np.add.at(out, row, msgs)
        x = out
    return x.astype(np.float32)


def augment_node_features(
    edge_index: np.ndarray,
    node_features: np.ndarray,
    use_sgc_features: bool = False,
    use_identity_features: bool = False,
    use_adjacency_features: bool = False,
    do_not_use_original_features: bool = False,
) -> np.ndarray:
    """``medium/dataset.py:322-351``: optionally append SGC-propagated
    features, the identity matrix, and/or dense adjacency rows."""
    n = node_features.shape[0]
    original = np.asarray(node_features, dtype=np.float32)
    parts = [] if do_not_use_original_features else [original]
    if use_sgc_features:
        parts.append(compute_sgc_features(edge_index, original))
    if use_identity_features:
        parts.append(np.eye(n, dtype=np.float32))
    if use_adjacency_features:
        e = remove_self_loops(np.asarray(edge_index))
        adj = np.zeros((n, n), dtype=np.float32)
        adj[e[1], e[0]] = 1.0
        parts.append(adj)
    if not parts:
        raise ValueError("all feature sources disabled")
    return np.concatenate(parts, axis=1)


def reorder_dataset(ds, method: str = "rcm"):
    """Relabel nodes for memory locality (bandwidth reduction), permuting
    features/labels/edges consistently.  The SpMM gather is the framework's
    memory-bound hot loop (the CSR SpMM kernel); clustering
    neighbors into nearby rows makes its random reads cache/prefetch
    friendly.  No reference equivalent.
    Returns (ds, perm) with ``perm[old] = new``; split indices generated
    AFTER reordering need no translation, precomputed ones do."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = ds.graph["num_nodes"]
    src, dst = np.asarray(ds.graph["edge_index"])
    if method == "rcm":
        a = sp.csr_matrix(
            (np.ones(len(src)), (dst, src)), shape=(n, n)
        )
        order = np.asarray(reverse_cuthill_mckee(a + a.T, symmetric_mode=True))
    elif method == "degree":
        deg = np.bincount(dst, minlength=n)
        order = np.argsort(-deg, kind="stable")
    else:
        raise ValueError(method)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    ds.graph["edge_index"] = np.stack([perm[src], perm[dst]])
    feat = ds.graph["node_feat"]
    if isinstance(feat, torch.Tensor):  # load_dataset's features, on their device
        ds.graph["node_feat"] = feat[torch.from_numpy(np.ascontiguousarray(order)).to(feat.device)]
    else:
        ds.graph["node_feat"] = np.asarray(feat)[order]
    if ds.label is not None:
        ds.label = np.asarray(ds.label)[order]
    return ds, perm


def gen_normalized_adjs(edge_index: np.ndarray, num_nodes: int):
    """(DAD, DA, AD) normalized adjacency triples as (src, dst, weight)
    edge sets (``large/data_utils.py:173-197``; used by the MultiLP/SGC
    family)."""
    src, dst = np.asarray(edge_index)
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    with np.errstate(divide="ignore"):
        d_half = deg**-0.5
        d_inv = 1.0 / deg
    d_half[~np.isfinite(d_half)] = 0.0
    d_inv[~np.isfinite(d_inv)] = 0.0
    dad = (src, dst, (d_half[dst] * d_half[src]).astype(np.float32))
    da = (src, dst, (d_inv[dst] * np.ones_like(d_half)[src]).astype(np.float32))
    ad = (src, dst, (np.ones_like(d_half)[dst] * d_inv[src]).astype(np.float32))
    return dad, da, ad


def adj_mul(edge_index: np.ndarray, num_nodes: int, power: int = 2):
    """Sparse adjacency power A^k edge list (NodeFormer's relational-bias
    hops; ``large/data_utils.py:255-260``).  Matches the reference's
    coalesced sparse product: unique structural edges, self-loop entries
    produced by the product are KEPT (verified against the reference's
    executing ``adj_mul`` in ``tests/test_reference_parity_infra.py``)."""
    import scipy.sparse as sp

    src, dst = np.asarray(edge_index)
    a = sp.csr_matrix(
        (np.ones(len(src)), (dst, src)), shape=(num_nodes, num_nodes)
    )
    ak = a
    for _ in range(power - 1):
        ak = ak @ a
    coo = (ak > 0).tocoo()
    return np.stack([coo.col, coo.row]).astype(np.int64)


def convert_to_adj(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Dense [N, N] adjacency (``large/data_utils.py:248-253``)."""
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    src, dst = np.asarray(edge_index)
    adj[dst, src] = 1.0
    return adj
