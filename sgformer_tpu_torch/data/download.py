"""Dataset fetch helper — the reference's Google-Drive downloader surface
(the SGFormer reference's ``large/dataset.py:371-377,423-428,444-449`` via
``googledrivedownloader``; file-id registry at
``large/data_utils.py:303-312``), rebuilt as an explicit, opt-in tool.

The port of ``sgformer_tpu/data/download.py``: the same registry, fetch
and offline error, through ``urllib`` alone.

Design stance (differs from the reference deliberately): the loaders in
:mod:`sgformer_tpu_torch.data.loaders` NEVER download implicitly — a
training job that silently reaches for Google Drive on a cache miss is
wrong on a GPU cluster too (no egress from workers, surprise multi-GB
fetches, quota failures mid-run).  Fetching is a separate, explicit step::

    python -m sgformer_tpu_torch.data.download pokec --data_dir /data

which places files exactly where the loaders expect them.  In an
air-gapped environment the command fails fast with
the manual-placement instructions instead of hanging.

The registry keys match ``load_dataset`` names; targets are the same
Drive artifacts the reference uses.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.error
import urllib.request

# Google-Drive file ids, from the reference's registry
# (large/data_utils.py:303-312).  Each entry: relative target path (under
# data_dir, matching what loaders.py expects) -> drive file id.
DRIVE_FILES: dict[str, dict[str, str]] = {
    "pokec": {"pokec/pokec.mat": "1dNs5E7BrWJbgcHeQ_zuy5Ozp2tRCWG0y"},
    "snap-patents": {"snap_patents.mat": "1ldh23TSY1PwXia6dU0MYcpyEgX-w3Hia"},
    "yelp-chi": {"YelpChi.mat": "1fAXtTVQS4CfEk4asqrFw9EPmlUPGbGtJ"},
}

# Fixed-split archives (large/data_utils.py:309-312).  The reference
# never actually consumes these ids in code (its pokec fixed split reads
# ``pokec/split_0.5_0.25/pokec_{train,valid,test}.txt`` and REGENERATES
# them when missing, large/dataset.py:399-415 — generated-split runs are
# what the published numbers used), so these are fetched to a holding
# file for manual extraction rather than a guessed layout.
DRIVE_SPLITS: dict[str, dict[str, str]] = {
    "pokec": {"pokec/splits-archive.bin": "1ZhpAiyTNc0cE_hhgyiqxnkKREHK7MK-_"},
    "snap-patents": {
        "snap_patents-splits-archive.bin": "12xbBRqd8mtG_XkNLH8dRRNZJvVM4Pw-N",
    },
}

_DRIVE_URL = "https://drive.usercontent.google.com/download?id={id}&confirm=t"


def drive_fetch(file_id: str, dest_path: str, *, timeout: float = 30.0) -> str:
    """Download one public Drive file to ``dest_path`` (makes parent dirs).

    Uses the direct usercontent endpoint with ``confirm=t`` (skips the
    large-file interstitial the reference's ``googledrivedownloader``
    handles with a cookie dance).  Raises ``ConnectionError`` with
    manual-placement instructions when the network is unreachable.
    """
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    url = _DRIVE_URL.format(id=file_id)
    tmp = dest_path + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            # Drive failure modes (quota exceeded, removed file, an
            # interstitial confirm=t didn't skip) come back as HTTP-200
            # HTML; committing that as the .mat would surface much later
            # as a confusing loadmat error — and the keep-existing rule
            # would pin the corrupt file.  Reject non-binary payloads.
            ctype = r.headers.get("Content-Type", "")
            first = r.read(1 << 20)
            head = first.lstrip()[:15].lower()
            if "text/html" in ctype or head.startswith(
                    (b"<!doctype", b"<html")):
                raise OSError(
                    f"drive returned an HTML page ({ctype!r}) instead of "
                    "file bytes — quota exceeded, file removed, or "
                    "interstitial not skipped"
                )
            f.write(first)
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest_path)
        return dest_path
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise ConnectionError(
            f"could not fetch drive id {file_id} -> {dest_path}: {e}\n"
            "If this environment has no egress, download the file on a "
            "connected machine from\n"
            f"  https://drive.google.com/uc?id={file_id}\n"
            f"and place it at {dest_path} — the loaders are purely "
            "file-gated and need nothing else."
        ) from e


def fetch_dataset(name: str, data_dir: str, *, splits: bool = False) -> list[str]:
    """Fetch every artifact ``load_dataset(data_dir, name)`` needs.

    Returns the list of paths written (existing files are kept).  Raises
    ``KeyError`` for datasets with no Drive source: OGB datasets come via
    the ``ogb`` package's own downloader, planetoid/heterophilous/
    wiki-filtered from their public GitHub releases — see
    ``docs/MIGRATION.md`` ("Data layout").
    """
    if name not in DRIVE_FILES:
        raise KeyError(
            f"no drive registry entry for {name!r}; registry covers "
            f"{sorted(DRIVE_FILES)} (other datasets ship via OGB or "
            "GitHub releases — docs/MIGRATION.md)"
        )
    wanted = dict(DRIVE_FILES[name])
    if splits:
        wanted.update(DRIVE_SPLITS.get(name, {}))
    written = []
    for rel, fid in wanted.items():
        dest = os.path.join(data_dir, rel)
        if os.path.exists(dest):
            print(f"[download] exists, keeping: {dest}", file=sys.stderr)
            continue
        written.append(drive_fetch(fid, dest))
        print(f"[download] fetched {dest}", file=sys.stderr)
    return written


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sgformer_tpu_torch.data.download",
        description="explicitly fetch reference dataset artifacts",
    )
    p.add_argument("dataset", choices=sorted(DRIVE_FILES))
    p.add_argument("--data_dir", default="data")
    p.add_argument("--splits", action="store_true",
                   help="also fetch the fixed-split archives (manual "
                        "extraction; generated splits are the default)")
    a = p.parse_args(argv)
    try:
        fetch_dataset(a.dataset, a.data_dir, splits=a.splits)
    except ConnectionError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
