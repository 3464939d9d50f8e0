"""Kinetics dataset acquisition (host tooling, CLI).

The port's own copy of the JAX package's ``data/kinetics_download.py``, a
rebuild of the reference's data/kinetics/download.py +
process_download_report.py: crawl the Kinetics CSV annotations (label,
youtube_id, time_start, time_end, split), fetch each clip with
yt-dlp/youtube-dl, and trim + preprocess it with ffmpeg using the
reference's exact filter -- scale to 256 short-side then center-crop
224x224 AT DOWNLOAD TIME (download.py:105-114), which is why the tfrecord
writers can store raw 224x224 frames.  Parallel over a thread pool; each
attempt is retried and logged to download_report.json; `summarize_report`
classifies failure reasons (process_download_report.py).

Both yt-dlp and ffmpeg are external binaries: without them every clip is
reported "missing yt-dlp/ffmpeg" and nothing is fetched.  The annotation
CSVs' 100-row samples ship with the package (``kinetics_annotations/``), so
the tool runs from the package's own files up to the downloader; the full
CSVs are fetched only by an explicit ``fetch_annotation`` call, and checked
against the manifest's sha256.

Usage:
  python -m flickering_adversarial_video_tpu_torch.data.kinetics_download \
      kinetics-400_val /data/kinetics/val [--jobs 8] [--limit N] \
      [--annotations-dir DIR]
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

FFMPEG_FILTER = "scale=256:256:force_original_aspect_ratio=increase,crop=224:224"

# Annotation CSVs (the reference ships them at data/kinetics/data/*.csv,
# 158k lines in all): a checksummed fetch manifest and a 100-row sample of
# each file (kinetics_annotations/*_sample.csv), so that the downloader runs
# from the package's own files up to the yt-dlp boundary, and a run with
# network access can fetch the full files and verify them byte for byte.

ANNOTATIONS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "kinetics_annotations")

_ANNOTATION_URL_BASE = (
    "https://raw.githubusercontent.com/roiponytch/"
    "Flickering_Adversarial_Video/master/data/kinetics/data"
)

# sha256 of the reference's exact files (public Kinetics annotation data;
# schema: label,youtube_id,time_start,time_end,split,is_cc)
ANNOTATION_MANIFEST: Dict[str, Dict[str, object]] = {
    "kinetics-400_val": {
        "url": f"{_ANNOTATION_URL_BASE}/kinetics-400_val.csv",
        "sha256": "358eaf47e7f80ebf9b17d49eb0635ad5e0fdab98a9cbd75ffdd2ee5d5e5b6944",
        "lines": 19907,
    },
    "kinetics-400_test": {
        "url": f"{_ANNOTATION_URL_BASE}/kinetics-400_test.csv",
        "sha256": "ab044f56e7ad5f055a74f1f36a74f95301c50ffb33fdd19ab56f898fb604f151",
        "lines": 35925,
    },
    "kinetics-600_val": {
        "url": f"{_ANNOTATION_URL_BASE}/kinetics-600_val.csv",
        "sha256": "3d596163bd75ac810e48c69662ce35ddd6737d44d351780f9533e11317a58d7a",
        "lines": 30001,
    },
    "kinetics-600_test": {
        "url": f"{_ANNOTATION_URL_BASE}/kinetics-600_test.csv",
        "sha256": "7dec5f5130a389ec92ee96e0cf5d83d35bb2c4f96e6d2f296df06c060ac0a462",
        "lines": 72925,
    },
}


def annotation_sample_path(name: str) -> str:
    """The 100-row sample CSV of a manifest entry (always present)."""
    if name not in ANNOTATION_MANIFEST:
        raise KeyError(f"unknown annotation {name!r}; "
                       f"have {sorted(ANNOTATION_MANIFEST)}")
    return os.path.join(ANNOTATIONS_DIR, f"{name}_sample.csv")


def _sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_annotation(name: str, dest_dir: str, *, timeout: int = 120) -> str:
    """Fetch the full annotation CSV (network access needed), verified
    against the manifest checksum (raises on mismatch); a valid file already
    there is not fetched again.  Returns the written path."""
    import urllib.request

    entry = ANNOTATION_MANIFEST[name]
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, f"{name}.csv")
    if not (os.path.exists(dest) and _sha256_file(dest) == entry["sha256"]):
        with urllib.request.urlopen(str(entry["url"]), timeout=timeout) as r:
            data = r.read()
        with open(dest, "wb") as f:
            f.write(data)
    got = _sha256_file(dest)
    if got != entry["sha256"]:
        raise ValueError(
            f"checksum mismatch for {name}: got {got}, "
            f"manifest says {entry['sha256']}"
        )
    return dest


def resolve_annotation_csv(name_or_path: str, search_dir: Optional[str] = None) -> str:
    """A CSV path for the downloader: a real file path passes through; a
    manifest name resolves to the fetched full CSV in `search_dir` when one
    is present (and checksum-valid), else the packaged 100-row sample."""
    if os.path.exists(name_or_path):
        return name_or_path
    if name_or_path not in ANNOTATION_MANIFEST:
        raise FileNotFoundError(name_or_path)
    if search_dir:
        full = os.path.join(search_dir, f"{name_or_path}.csv")
        entry = ANNOTATION_MANIFEST[name_or_path]
        if os.path.exists(full) and _sha256_file(full) == entry["sha256"]:
            return full
    return annotation_sample_path(name_or_path)


def _downloader_binary() -> Optional[str]:
    for name in ("yt-dlp", "youtube-dl"):
        if shutil.which(name):
            return name
    return None


def read_kinetics_csv(csv_path: str) -> List[Dict[str, str]]:
    """Rows with keys label, youtube_id, time_start, time_end, split."""
    with open(csv_path) as f:
        return list(csv.DictReader(f))


def download_clip(
    row: Dict[str, str],
    out_dir: str,
    *,
    retries: int = 5,
    crop: bool = True,
    timeout: int = 300,
) -> Tuple[str, str]:
    """Returns (youtube_id, status); status 'ok' or an error string."""
    ytid = row["youtube_id"]
    # test splits are unlabeled (kinetics-600_test.csv has no label column);
    # the reference routes those clips to a flat 'test' directory
    label = row.get("label", "test").replace(" ", "_")
    start = float(row["time_start"])
    end = float(row["time_end"])
    class_dir = os.path.join(out_dir, label)
    os.makedirs(class_dir, exist_ok=True)
    dest = os.path.join(class_dir, f"{ytid}.mp4")
    if os.path.exists(dest):
        return ytid, "ok"
    dl = _downloader_binary()
    if dl is None or shutil.which("ffmpeg") is None:
        return ytid, "missing yt-dlp/ffmpeg"

    tmp = dest + ".tmp.mp4"
    last_err = "unknown"
    for _ in range(retries):
        try:
            fetch = subprocess.run(
                [dl, "-f", "mp4", "-o", tmp, f"https://youtu.be/{ytid}"],
                capture_output=True,
                timeout=timeout,
                text=True,
            )
            if fetch.returncode != 0:
                last_err = (fetch.stderr or "download failed").strip().splitlines()[-1]
                continue
            cmd = [
                "ffmpeg", "-y", "-ss", str(start), "-to", str(end), "-i", tmp,
            ]
            if crop:
                cmd += ["-vf", FFMPEG_FILTER]
            cmd += ["-c:v", "libx264", "-an", dest]
            trim = subprocess.run(cmd, capture_output=True, timeout=timeout, text=True)
            if trim.returncode == 0:
                return ytid, "ok"
            last_err = (trim.stderr or "ffmpeg failed").strip().splitlines()[-1]
        except subprocess.TimeoutExpired:
            last_err = "timeout"
        except Exception as e:  # noqa: BLE001 — report, don't crash the crawl
            last_err = str(e)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ytid, last_err


def download_dataset(
    csv_path: str,
    out_dir: str,
    *,
    jobs: int = 8,
    limit: Optional[int] = None,
    report_path: Optional[str] = None,
) -> Dict[str, str]:
    rows = read_kinetics_csv(csv_path)[:limit]
    report: Dict[str, str] = {}
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        for ytid, status in ex.map(lambda r: download_clip(r, out_dir), rows):
            report[ytid] = status
    report_path = report_path or os.path.join(out_dir, "download_report.json")
    os.makedirs(os.path.dirname(report_path), exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    return report


def summarize_report(report_path: str) -> Dict[str, int]:
    """Failure-reason histogram (process_download_report.py equivalent)."""
    with open(report_path) as f:
        report = json.load(f)
    summary: Dict[str, int] = {}
    for status in report.values():
        key = "ok" if status == "ok" else (
            "unavailable" if "unavailable" in status.lower()
            else "copyright" if "copyright" in status.lower()
            else "timeout" if status == "timeout"
            else "missing tools" if "missing" in status
            else "other"
        )
        summary[key] = summary.get(key, 0) + 1
    return summary


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument(
        "csv",
        help="kinetics annotation csv path, or a manifest name "
        f"({', '.join(sorted(ANNOTATION_MANIFEST))}) resolved to a fetched "
        "full CSV if present else the packaged 100-row sample",
    )
    p.add_argument("out_dir")
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument(
        "--annotations-dir",
        default=None,
        help="directory holding fetched full CSVs (see fetch_annotation)",
    )
    args = p.parse_args(argv)
    csv_path = resolve_annotation_csv(args.csv, args.annotations_dir)
    report = download_dataset(csv_path, args.out_dir, jobs=args.jobs, limit=args.limit)
    print(json.dumps(summarize_report(os.path.join(args.out_dir, "download_report.json")), indent=1))


if __name__ == "__main__":
    main()
