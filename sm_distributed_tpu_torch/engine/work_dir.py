"""Work-dir staging with pluggable fetchers and partial-fetch resume.

Port of ``sm_distributed_tpu/engine/work_dir.py``.  ``WorkDirManager``
stages a job's input under ``<work_root>/<ds_id>/input`` through a fetcher:

- ``LocalFetcher`` — plain filesystem copies, for paths and ``file://``
  URIs (an imzML file brings its ``.ibd`` sibling along; a directory is
  staged recursively);
- ``S3Fetcher`` — ``s3://bucket/key`` URIs via boto3, imported lazily: a
  machine without boto3 fails with guidance;
- any object with the two-method interface (tests inject a fake remote).

Resume is per file: each file lands under a temp name, is size-checked and
renamed into place, files whose (size, version) match the source listing
are skipped, and the manifest commits the staging only once every file is
in.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_FETCH = register_failpoint(
    "workdir.fetch", "before fetching one staging file (remote I/O error)")
FP_STAGE_RENAME = register_failpoint(
    "workdir.stage_rename",
    "between a file's .part fetch and its rename into input/ (torn fetch)")


def sibling_ibd_names(filename: str) -> tuple[str, ...]:
    """Candidate .ibd sibling names for an imzML file (either extension
    case style), else empty — the ONE pairing rule both fetchers share, so
    local and S3 staging can't silently disagree on which inputs bring
    their binary sibling along."""
    if not filename.lower().endswith(".imzml"):
        return ()
    base = filename[: filename.rfind(".")]
    return (base + ".ibd", base + ".IBD")


class LocalFetcher:
    """Filesystem staging: ``src`` is a file (imzML; the sibling .ibd comes
    along) or a directory staged recursively with relative layout preserved
    (basename flattening would silently overwrite same-named files)."""

    def list_files(self, src: str | Path) -> dict[str, list]:
        """{relpath: [size, version]} — the staging manifest entries."""
        src = Path(src)
        if not src.exists():
            raise FileNotFoundError(f"input path does not exist: {src}")
        if src.is_file():
            out = {src.name: self._sig(src)}
            for name in sibling_ibd_names(src.name):
                ibd = src.with_name(name)
                if ibd.exists():
                    out[ibd.name] = self._sig(ibd)
                    break
            return out
        return {
            str(p.relative_to(src)): self._sig(p)
            for p in sorted(src.rglob("*")) if p.is_file()
        }

    @staticmethod
    def _sig(p: Path) -> list:
        st = p.stat()
        return [st.st_size, str(int(st.st_mtime))]

    def fetch_file(self, src: str | Path, rel: str, dst: Path) -> None:
        src = Path(src)
        # file source: rel is the file itself or its sibling .ibd
        origin = src.with_name(rel) if src.is_file() else src / rel
        shutil.copy2(origin, dst)


class S3Fetcher:
    """``s3://bucket/prefix`` staging via boto3 (the reference stages from
    S3 with boto).  Constructing this fetcher without boto3 fails with
    guidance instead of at first use."""

    def __init__(self, client=None):
        """``client``: an injected S3 client (tests exercise the listing and
        sibling logic with a fake); default constructs a real boto3 client."""
        if client is None:
            try:
                import boto3
            except ImportError as e:
                raise ImportError(
                    "s3:// staging needs boto3, which is not available in "
                    "this environment; stage the input locally (any "
                    "filesystem path) or install boto3") from e
            client = boto3.client("s3")
        self._s3 = client
        self._keys: dict[str, str] = {}   # rel -> exact object key (per src)

    @staticmethod
    def _split(uri: str) -> tuple[str, str]:
        rest = uri[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix

    def _head(self, bucket: str, key: str) -> tuple[list | None, bool]:
        """``([size, etag] | None, denied)`` — one HEAD request instead of
        paginating the whole prefix to detect an exact-key match.
        404 = absent; 403 = HEAD denied (least-privilege policies return it
        both for missing s3:GetObject on an existing key and for a missing
        key without s3:ListBucket) — the caller falls through to the
        directory listing, and surfaces the denial if nothing else stages
        so a permissions problem doesn't masquerade as 'no objects'."""
        try:
            h = self._s3.head_object(Bucket=bucket, Key=key)
        except self._s3.exceptions.ClientError as e:
            meta = e.response.get("ResponseMetadata", {})
            code = meta.get("HTTPStatusCode")
            if code in (403, 404):
                return None, code == 403
            raise
        return [h["ContentLength"], h["ETag"].strip('"')], False

    def list_files(self, src: str) -> dict[str, list]:
        """An exact-key URI stages that one object (plus its .ibd sibling
        when it names an .imzML — the reader needs the pair, mirroring
        LocalFetcher); otherwise the prefix is treated as a directory and
        listed '/'-terminated, so a sibling prefix (ds1 vs ds10) can never
        leak into the listing.  Exact object keys are recorded for
        fetch_file — relpaths are never re-derived."""
        bucket, prefix = self._split(str(src))
        self._keys = {}
        out: dict[str, list] = {}
        exact, denied = ((None, False) if not prefix or prefix.endswith("/")
                         else self._head(bucket, prefix))
        if exact is not None:
            rel = Path(prefix).name
            self._keys[rel] = prefix
            out[rel] = exact
            key_dir = prefix[: -len(rel)]
            for name in sibling_ibd_names(rel):
                ibd, _ = self._head(bucket, key_dir + name)
                if ibd is not None:
                    self._keys[name] = key_dir + name
                    out[name] = ibd
                    break
            return out
        paginator = self._s3.get_paginator("list_objects_v2")
        dir_prefix = prefix.rstrip("/") + "/" if prefix else ""
        for page in paginator.paginate(Bucket=bucket, Prefix=dir_prefix):
            for obj in page.get("Contents", []):
                rel = obj["Key"][len(dir_prefix):]
                # skip console-created zero-byte "folder marker" keys — as
                # files they would shadow the directory and break mkdir
                if not rel or rel.endswith("/"):
                    continue
                self._keys[rel] = obj["Key"]
                out[rel] = [obj["Size"], obj["ETag"].strip('"')]
        if not out:
            if denied:
                raise PermissionError(
                    f"HEAD on {src} was denied (403) and no objects are "
                    "listable under it — check s3:GetObject/s3:ListBucket "
                    "permissions for this key")
            raise FileNotFoundError(f"no objects under {src}")
        return out

    def fetch_file(self, src: str, rel: str, dst: Path) -> None:
        bucket, _prefix = self._split(str(src))
        key = self._keys.get(rel)
        if key is None:
            raise KeyError(f"{rel} not in the current listing for {src}")
        self._s3.download_file(bucket, key, str(dst))


def resolve_fetcher(input_path: str | Path):
    """Pick a fetcher from the input URI scheme (plain paths -> local)."""
    s = str(input_path)
    if s.startswith("s3://"):
        return S3Fetcher()
    if "://" in s and not s.startswith("file://"):
        raise ValueError(f"unsupported input scheme: {s}")
    return LocalFetcher()


class WorkDirManager:
    """Per-dataset scratch dir: ``<work_root>/<ds_id>/``.

    ``fetcher``: staging backend override (tests inject a fake remote);
    default resolves from the input URI at copy_input_data time.
    """

    def __init__(self, work_root: str | Path, ds_id: str, fetcher=None):
        self.path = Path(work_root) / ds_id
        self.path.mkdir(parents=True, exist_ok=True)
        self.fetcher = fetcher

    def copy_input_data(self, input_path: str | Path) -> Path:
        """Stage input into ``<work_dir>/input``; per-file skip-if-current.

        A file is refetched only when absent or when its (size, version)
        no longer matches the source listing; extraneous local files are
        removed; the manifest commits the staging only once complete."""
        fetcher = self.fetcher or resolve_fetcher(input_path)
        s = str(input_path)
        if s.startswith("file://"):
            src: str | Path = Path(s[len("file://"):])   # plain local path
        elif "://" in s:
            src = s
        else:
            src = Path(s)
        listing = fetcher.list_files(src)
        dst = self.path / "input"
        manifest = self.path / "input.manifest.json"
        staged: dict = {}
        if manifest.exists():
            try:
                staged = json.loads(manifest.read_text())
            except json.JSONDecodeError:
                staged = {}
        # the manifest alone is not proof: a file deleted from dst since the
        # last staging must fall through to the per-file fetch loop
        if (staged == listing and dst.exists()
                and all((dst / rel).is_file() for rel in listing)):
            logger.info("work_dir: input already staged at %s, skipping", dst)
            return dst
        manifest.unlink(missing_ok=True)  # staging no longer current
        dst.mkdir(parents=True, exist_ok=True)
        # drop extraneous files from a previous (different) staging
        keep = {dst / rel for rel in listing}
        for p in sorted(dst.rglob("*"), reverse=True):
            if p.is_file() and p not in keep:
                p.unlink()
            elif p.is_dir() and not any(p.iterdir()):
                p.rmdir()
        fetched = 0
        for rel, sig in listing.items():
            out = dst / rel
            if out.exists() and staged.get(rel) == sig:
                record_recovery("workdir.resume_skip")
                continue                     # survived a partial staging
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(out.name + ".part")
            failpoint(FP_FETCH, path=tmp)
            fetcher.fetch_file(src, rel, tmp)
            failpoint(FP_STAGE_RENAME, path=tmp)
            # verify the byte count against the source listing BEFORE the
            # rename commits it: a torn/partial fetch must never be recorded
            # as current (the manifest would then skip it forever)
            got = tmp.stat().st_size
            if got != int(sig[0]):
                tmp.unlink(missing_ok=True)
                raise OSError(
                    f"staging fetched {got} bytes for {rel}, source lists "
                    f"{sig[0]} — torn or concurrent write, refusing to commit")
            tmp.replace(out)
            # commit per file: a crash mid-staging resumes from here
            staged[rel] = sig
            manifest.write_text(json.dumps(staged))
            fetched += 1
        manifest.write_text(json.dumps(listing))
        logger.info("work_dir: staged %s -> %s (%d fetched, %d current)",
                    src, dst, fetched, len(listing) - fetched)
        return dst

    def imzml_path(self) -> Path:
        root = self.path / "input"
        hits = sorted(root.rglob("*.imzML")) or sorted(root.rglob("*.imzml"))
        if not hits:
            raise FileNotFoundError(f"no .imzML file staged under {root}")
        return hits[0]

    def exists(self, name: str) -> bool:
        return (self.path / name).exists()

    def file(self, name: str) -> Path:
        return self.path / name

    def clean(self) -> None:
        """Remove the whole per-dataset scratch dir (the reference's
        ``WorkDir.clean``)."""
        if self.path.exists():
            shutil.rmtree(self.path)
            logger.info("work_dir: cleaned %s", self.path)
