"""ScanNet release downloader: the port's copy of
`vdetr_tpu/data/download_scannet.py` (reference scannet/download-scannet.py),
standard library only.

The ScanNet data are distributed by TU Munich behind a terms-of-service
agreement: you must first email the ScanNet authors and agree to the
TOS (http://kaldir.vc.in.tum.de/scannet/ScanNet_TOS.pdf). The CLI takes
the reference's surface: whole-release or per-scan download, v1/v2
selection, per-filetype filtering, the label-map and task-data extras,
plus resumable downloads (temp file + rename) and --dry_run.

The same URLs, output paths, printed lines and exit codes as the JAX
module. `BASE_URL` is read at call time, so a caller may point the
module at a mirror (a `file://` one too) by setting it.

Usage:
  python -m vdetr_tpu_torch.data.download_scannet -o scannet/
      [--id scene0000_00] [--type _vh_clean_2.ply] [--v1] [--label_map]
      [--task_data] [--test_scans] [--yes] [--dry_run]

Downstream: feed the scans directory (OUT/scans) and the label map
(OUT/scannetv2-labels.combined.tsv) to vdetr_tpu_torch/data/prep_scannet.py.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import urllib.request

BASE_URL = "http://kaldir.vc.in.tum.de/scannet/"
TOS_URL = BASE_URL + "ScanNet_TOS.pdf"
FILETYPES = [
    ".aggregation.json",
    ".sens",
    ".txt",
    "_vh_clean.ply",
    "_vh_clean_2.0.010000.segs.json",
    "_vh_clean_2.ply",
    "_vh_clean.segs.json",
    "_vh_clean.aggregation.json",
    "_vh_clean_2.labels.ply",
    "_2d-instance.zip",
    "_2d-instance-filt.zip",
    "_2d-label.zip",
    "_2d-label-filt.zip",
]
FILETYPES_TEST = [".sens", ".txt", "_vh_clean.ply", "_vh_clean_2.ply"]
RELEASES = {"v2": "v2/scans", "v1": "v1/scans"}
RELEASES_TASKS = {"v2": "v2/tasks", "v1": "v1/tasks"}
RELEASE_SIZE = {"v2": "1.2TB", "v1": "866GB"}
LABEL_MAP_FILES = {"v2": "scannetv2-labels.combined.tsv",
                   "v1": "scannet-labels.combined.tsv"}
# task data, always from the v1 tasks path
TASK_FILES = ("obj_classification/data.zip",
              "obj_classification/trained_models.zip",
              "voxel_labeling/data.zip",
              "voxel_labeling/trained_models.zip",
              "benchmark/scannet-benchmark.zip")


def fetch_scan_list(release: str) -> list:
    """Scan ids of a release from the server's <release>/scans.txt,
    blank lines dropped."""
    with urllib.request.urlopen(f"{BASE_URL}{release}/scans.txt") as r:
        return [ln.strip() for ln in r.read().decode().splitlines()
                if ln.strip()]


def download_file(url: str, out_file: str, dry_run: bool = False) -> bool:
    """Fetch url -> out_file: skipped if present (under --dry_run too);
    fetched to a temp file in the target directory and renamed into
    place, so an interrupted download leaves no truncated file. A failed
    fetch removes the temp file, reports on stderr and returns False."""
    if os.path.isfile(out_file):
        print(f"  {out_file} exists, skipping")
        return True
    if dry_run:
        print(f"  [dry-run] {url} -> {out_file}")
        return True
    out_dir = os.path.dirname(out_file) or "."
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir)
    os.close(fd)
    try:
        print(f"  {url} -> {out_file}")
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, out_file)
        return True
    except Exception as e:  # noqa: BLE001
        if os.path.exists(tmp):
            os.remove(tmp)
        print(f"  ERROR downloading {url}: {e}", file=sys.stderr)
        return False


def download_scan(scan_id: str, out_dir: str, file_types, release: str,
                  dry_run: bool = False):
    """Each of `file_types` of one scan into OUT/scans/<id>/<id><type>.
    A failed file does not stop the others, nor change the exit code."""
    print(f"Downloading ScanNet {release} scan {scan_id} ...")
    scan_dir = os.path.join(out_dir, "scans", scan_id)
    for ft in file_types:
        url = f"{BASE_URL}{RELEASES[release]}/{scan_id}/{scan_id}{ft}"
        download_file(url, os.path.join(scan_dir, scan_id + ft), dry_run)


def download_label_map(out_dir: str, release: str, dry_run: bool = False):
    fname = LABEL_MAP_FILES[release]
    download_file(f"{BASE_URL}{RELEASES_TASKS[release]}/{fname}",
                  os.path.join(out_dir, fname), dry_run)


def download_task_data(out_dir: str, dry_run: bool = False):
    for f in TASK_FILES:
        download_file(f"{BASE_URL}{RELEASES_TASKS['v1']}/{f}",
                      os.path.join(out_dir, "tasks", os.path.basename(f)),
                      dry_run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Download the ScanNet dataset (TOS-gated; see "
                    + TOS_URL + ")")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--task_data", action="store_true",
                   help="download task data (v1)")
    p.add_argument("--label_map", action="store_true",
                   help="download the label mapping file only")
    p.add_argument("--v1", action="store_true",
                   help="download ScanNet v1 instead of v2")
    p.add_argument("--id", help="specific scan id to download")
    p.add_argument("--type", choices=FILETYPES,
                   help="specific file type to download")
    p.add_argument("--test_scans", action="store_true",
                   help="download the test split (reduced filetypes)")
    p.add_argument("--yes", action="store_true",
                   help="skip the interactive TOS confirmation")
    p.add_argument("--dry_run", action="store_true",
                   help="print what would be downloaded")
    args = p.parse_args(argv)

    release = "v1" if args.v1 else "v2"
    if not args.yes and not args.dry_run:
        print(f"By continuing you confirm you have agreed to the ScanNet "
              f"TOS ({TOS_URL}).\nThe full {release} release is "
              f"{RELEASE_SIZE[release]}. Press Enter to continue, "
              f"Ctrl-C to abort.")
        try:
            input("")
        except KeyboardInterrupt:
            return 1

    # the extras return before any scan is fetched; the label map wins
    if args.label_map:
        download_label_map(args.out_dir, release, args.dry_run)
        return 0
    if args.task_data:
        download_task_data(args.out_dir, args.dry_run)
        return 0

    file_types = [args.type] if args.type else (
        FILETYPES_TEST if args.test_scans else FILETYPES)
    if args.id:
        scans = [args.id]
    else:
        scans = fetch_scan_list(release)
        print(f"{len(scans)} scans in the {release} release")
    for sid in scans:
        download_scan(sid, args.out_dir, file_types, release, args.dry_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
