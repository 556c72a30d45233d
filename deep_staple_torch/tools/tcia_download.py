"""A TCIA / NBIA downloader.

The port's copy of `deep_staple_tpu/tools/tcia_download.py`, after
`preprocessing/fetch_dataset.ipynb` cells 3-6: the reference downloads the
Vestibular-Schwannoma-SEG collection by installing the NBIA Data Retriever
.deb and driving its CLI with a .tcia manifest. Here the same data comes
from NBIA's public REST API, with no java runtime:

  * ``GET {base}/getSeries?Collection=<name>``  -> JSON series inventory,
  * ``GET {base}/getImage?SeriesInstanceUID=<uid>`` -> zip of the series'
    DICOM files,

plus a parser for the ``.tcia`` manifest the reference feeds the retriever
(key=value header, then ``ListOfSeriesToDownload=`` followed by one
SeriesInstanceUID per line).

Every function takes ``base_url``, so tests run against a local server; the
default is the public NBIA v1 endpoint the retriever uses.
"""

from __future__ import annotations

import io
import json
import time
import shutil
import urllib.parse
import urllib.request
import zipfile
from pathlib import Path

NBIA_BASE = "https://services.cancerimagingarchive.net/nbia-api/services/v1"
TCIA_COLLECTION = "Vestibular-Schwannoma-SEG"


def parse_tcia_manifest(path) -> list[str]:
    """SeriesInstanceUIDs from a .tcia manifest file."""
    uids: list[str] = []
    in_list = False
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("ListOfSeriesToDownload="):
            in_list = True
            rest = line.split("=", 1)[1].strip()
            if rest:
                uids.append(rest)
            continue
        if in_list:
            if "=" in line and not line[0].isdigit():
                in_list = False  # another key=value section
                continue
            uids.append(line)
    return uids


def _get(url: str, retries: int = 3, backoff: float = 2.0) -> bytes:
    last: Exception | None = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                return r.read()
        except Exception as e:  # urllib raises several unrelated types
            last = e
            if attempt + 1 < retries:
                time.sleep(backoff * (attempt + 1))
    raise RuntimeError(f"GET {url} failed after {retries} attempts: {last}")


def list_series(collection: str = TCIA_COLLECTION, base_url: str = NBIA_BASE) -> list[dict]:
    url = f"{base_url}/getSeries?Collection={urllib.parse.quote(collection)}"
    return json.loads(_get(url).decode())


_DONE_MARKER = ".series_complete"


def download_series(series_uid: str, out_dir, base_url: str = NBIA_BASE,
                    retries: int = 3) -> list[Path]:
    """Fetch one series' DICOM zip and extract it under out_dir/<uid>/.

    Zip member paths are preserved (sanitized against absolute/`..` escapes)
    so same-named files in different subdirectories cannot clobber each
    other; a completion marker is written only after the full extraction, so
    an interrupted series is re-downloaded rather than silently resumed with
    missing slices.
    """
    url = f"{base_url}/getImage?SeriesInstanceUID={urllib.parse.quote(series_uid)}"
    payload = _get(url, retries=retries)
    dest = Path(out_dir) / series_uid
    if dest.is_dir():
        shutil.rmtree(dest)  # stale partial extraction must not survive a re-fetch
    dest.mkdir(parents=True, exist_ok=True)
    written = []
    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        for name in zf.namelist():
            if name.endswith("/"):
                continue
            parts = [p for p in Path(name).parts if p not in ("..", "", "/", ".")]
            if not parts:
                continue
            target = dest / Path(*parts)
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(zf.read(name))
            written.append(target)
    (dest / _DONE_MARKER).write_text(f"{len(written)}\n")
    return written


def download_collection(out_dir, collection: str = TCIA_COLLECTION,
                        manifest: str | None = None, base_url: str = NBIA_BASE,
                        retries: int = 3) -> dict:
    """Download a whole collection (or just a manifest's series list).

    Returns {series_uid: [extracted paths]}. Series whose completion marker
    exists are skipped, so interrupted downloads resume; a partially
    extracted series (no marker) is re-fetched in full.
    """
    if manifest is not None:
        uids = parse_tcia_manifest(manifest)
    else:
        uids = [s["SeriesInstanceUID"] for s in list_series(collection, base_url)]
    out: dict = {}
    for i, uid in enumerate(uids):
        dest = Path(out_dir) / uid
        if (dest / _DONE_MARKER).is_file():
            out[uid] = sorted(p for p in dest.rglob("*") if p.is_file() and p.name != _DONE_MARKER)
            continue
        print(f"[{i + 1}/{len(uids)}] {uid}")
        out[uid] = download_series(uid, out_dir, base_url, retries=retries)
    return out
