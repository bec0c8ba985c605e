"""Native imzML + ibd reader/writer (copy of ``sm_distributed_tpu/io/imzml.py``
with the same fault-injection seams, ``io.imzml_parse`` and ``io.ibd_read``).

The reference parses imzML via the external ``pyimzML`` library inside
``sm/engine/imzml_txt_converter.py::ImzmlTxtConverter.convert`` [U]
(SURVEY.md #4) and round-trips through a line-per-spectrum text file for
Spark.  We parse the binary format natively and keep everything as numpy
arrays — there is no text intermediate; the dataset (io/dataset.py)
consumes the arrays directly.

Format essentials (imzML 1.1, built on mzML 1.1):
- ``.imzML``: XML; file-level cvParam IMS:1000030 (continuous) or
  IMS:1000031 (processed); per-spectrum scan position IMS:1000050/51 (x/y);
  per-binaryDataArray external byte offset IMS:1000102, array length
  IMS:1000103, encoded length IMS:1000104; array kind MS:1000514 (m/z) /
  MS:1000515 (intensity); dtype MS:1000521/523/519/522 (f32/f64/i32/i64).
  Array kind + dtype commonly live in a referenceableParamGroup.
- ``.ibd``: 16-byte UUID (must match imzML IMS:1000080), then raw arrays.
  Continuous mode: one shared m/z array, per-spectrum intensity arrays.
"""

from __future__ import annotations

import uuid as uuid_mod
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.failpoints import failpoint, register_failpoint

FP_IMZML_PARSE = register_failpoint(
    "io.imzml_parse", "start of imzML XML parse (corrupt/unreadable imzML)")
FP_IBD_READ = register_failpoint(
    "io.ibd_read", "per-array ibd read (I/O error / truncation mid-ingest)")

_DTYPES = {
    "MS:1000521": np.dtype("<f4"),
    "MS:1000523": np.dtype("<f8"),
    "MS:1000519": np.dtype("<i4"),
    "MS:1000522": np.dtype("<i8"),
    # IMS legacy aliases seen in the wild
    "IMS:1000101": np.dtype("<f4"),
}
_MZ_ARRAY = "MS:1000514"
_INT_ARRAY = "MS:1000515"
_CONTINUOUS = "IMS:1000030"
_PROCESSED = "IMS:1000031"
_UUID = "IMS:1000080"
_POS_X = "IMS:1000050"
_POS_Y = "IMS:1000051"
_EXT_OFFSET = "IMS:1000102"
_EXT_ARR_LEN = "IMS:1000103"


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


@dataclass
class _ArrayRef:
    offset: int
    length: int
    dtype: np.dtype


@dataclass
class SpectrumRef:
    """Lazy handle to one spectrum's arrays in the ibd file."""
    x: int
    y: int
    mz: _ArrayRef
    intensity: _ArrayRef


class ImzMLParseError(ValueError):
    pass


class ImzMLReader:
    """Streams spectra out of an imzML/ibd pair.

    Usage::
        rd = ImzMLReader("ds.imzML")
        for i in range(rd.n_spectra):
            x, y = rd.coordinates[i]
            mzs, ints = rd.read_spectrum(i)
    """

    def __init__(self, imzml_path: str | Path, ibd_path: str | Path | None = None):
        self.imzml_path = Path(imzml_path)
        self.ibd_path = Path(ibd_path) if ibd_path else self.imzml_path.with_suffix(".ibd")
        if not self.ibd_path.exists():
            # handle .imzml/.IBD case variants
            for cand in self.imzml_path.parent.glob("*"):
                if cand.suffix.lower() == ".ibd" and cand.stem == self.imzml_path.stem:
                    self.ibd_path = cand
                    break
        if not self.ibd_path.exists():
            raise FileNotFoundError(f"ibd file for {self.imzml_path} not found")
        self.continuous: bool | None = None
        self.uuid: str | None = None
        self.spectra: list[SpectrumRef] = []
        self._parse_xml()
        self._ibd = open(self.ibd_path, "rb")
        self._check_uuid()

    # -- parsing ---------------------------------------------------------

    def _parse_xml(self) -> None:
        failpoint(FP_IMZML_PARSE, path=self.imzml_path)
        param_groups: dict[str, list[tuple[str, str]]] = {}
        cur_group: str | None = None
        in_spectrum = False
        pos_x = pos_y = None
        arrays: list[dict] = []
        cur_array: dict | None = None

        for event, elem in ET.iterparse(self.imzml_path, events=("start", "end")):
            tag = _local(elem.tag)
            if event == "start":
                if tag == "referenceableParamGroup":
                    cur_group = elem.get("id")
                    param_groups[cur_group] = []
                elif tag == "spectrum":
                    in_spectrum = True
                    pos_x = pos_y = None
                    arrays = []
                elif tag == "binaryDataArray" and in_spectrum:
                    cur_array = {"accessions": {}}
                continue

            # end events
            if tag == "cvParam":
                acc = elem.get("accession", "")
                val = elem.get("value", "")
                if cur_group is not None and not in_spectrum:
                    param_groups[cur_group].append((acc, val))
                elif cur_array is not None:
                    cur_array["accessions"][acc] = val
                elif in_spectrum:
                    if acc == _POS_X:
                        pos_x = int(float(val))
                    elif acc == _POS_Y:
                        pos_y = int(float(val))
                else:
                    if acc == _CONTINUOUS:
                        self.continuous = True
                    elif acc == _PROCESSED:
                        self.continuous = False
                    elif acc == _UUID:
                        self.uuid = val.strip("{}").replace("-", "").lower()
            elif tag == "referenceableParamGroupRef" and cur_array is not None:
                ref = elem.get("ref")
                for acc, val in param_groups.get(ref, []):
                    cur_array["accessions"].setdefault(acc, val)
            elif tag == "binaryDataArray" and cur_array is not None:
                arrays.append(cur_array)
                cur_array = None
            elif tag == "spectrum":
                self._finish_spectrum(pos_x, pos_y, arrays)
                in_spectrum = False
                elem.clear()
            elif tag in ("spectrumList", "run", "mzML"):
                elem.clear()

        if self.continuous is None:
            raise ImzMLParseError(
                f"{self.imzml_path}: neither continuous ({_CONTINUOUS}) nor "
                f"processed ({_PROCESSED}) file-content cvParam found"
            )
        if not self.spectra:
            raise ImzMLParseError(f"{self.imzml_path}: no spectra")

    def _finish_spectrum(self, pos_x, pos_y, arrays) -> None:
        if pos_x is None or pos_y is None:
            raise ImzMLParseError(
                f"{self.imzml_path}: spectrum {len(self.spectra)} missing scan position"
            )
        mz_ref = int_ref = None
        for arr in arrays:
            acc = arr["accessions"]
            dtype = None
            for code, dt in _DTYPES.items():
                if code in acc:
                    dtype = dt
                    break
            if dtype is None or _EXT_OFFSET not in acc or _EXT_ARR_LEN not in acc:
                raise ImzMLParseError(
                    f"{self.imzml_path}: binaryDataArray missing dtype/offset/length"
                )
            ref = _ArrayRef(
                offset=int(acc[_EXT_OFFSET]), length=int(acc[_EXT_ARR_LEN]), dtype=dtype
            )
            if _MZ_ARRAY in acc:
                mz_ref = ref
            elif _INT_ARRAY in acc:
                int_ref = ref
        if mz_ref is None or int_ref is None:
            raise ImzMLParseError(
                f"{self.imzml_path}: spectrum {len(self.spectra)} lacks m/z or intensity array"
            )
        self.spectra.append(SpectrumRef(x=pos_x, y=pos_y, mz=mz_ref, intensity=int_ref))

    def _check_uuid(self) -> None:
        raw = self._ibd.read(16)
        if len(raw) != 16:
            raise ImzMLParseError(f"{self.ibd_path}: shorter than the 16-byte UUID header")
        if self.uuid and raw.hex() != self.uuid:
            raise ImzMLParseError(
                f"ibd UUID {raw.hex()} does not match imzML UUID {self.uuid}"
            )

    # -- access ----------------------------------------------------------

    @property
    def n_spectra(self) -> int:
        return len(self.spectra)

    @property
    def coordinates(self) -> np.ndarray:
        """(n_spectra, 2) int array of raw (x, y) scan positions."""
        return np.array([(s.x, s.y) for s in self.spectra], dtype=np.int64)

    def _read_array(self, ref: _ArrayRef) -> np.ndarray:
        failpoint(FP_IBD_READ, path=self.ibd_path)
        self._ibd.seek(ref.offset)
        raw = self._ibd.read(ref.length * ref.dtype.itemsize)
        if len(raw) != ref.length * ref.dtype.itemsize:
            raise ImzMLParseError(f"{self.ibd_path}: truncated read at offset {ref.offset}")
        return np.frombuffer(raw, dtype=ref.dtype)

    def spectrum_lengths(self) -> np.ndarray:
        """(n_spectra,) int64 peak counts WITHOUT touching the ibd data —
        lengths come from the XML array metadata, which is what lets
        ingestion preallocate exact CSR arrays and stream spectra into them
        with bounded working memory (SpectralDataset.from_imzml)."""
        return np.array([s.mz.length for s in self.spectra], dtype=np.int64)

    def read_spectrum(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(mzs float64, intensities float32) of spectrum i."""
        s = self.spectra[i]
        mzs = self._read_array(s.mz).astype(np.float64)
        ints = self._read_array(s.intensity).astype(np.float32)
        if mzs.shape != ints.shape:
            raise ImzMLParseError(f"spectrum {i}: mz/intensity length mismatch")
        return mzs, ints

    def close(self) -> None:
        self._ibd.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ImzMLWriter:
    """Writes spectra to an imzML/ibd pair (both modes). Used by the synthetic
    fixture generator and by tests; also gives users a migration path off
    text dumps."""

    def __init__(self, path: str | Path, continuous: bool = False,
                 mz_dtype=np.float64, int_dtype=np.float32):
        self.imzml_path = Path(path)
        self.ibd_path = self.imzml_path.with_suffix(".ibd")
        self.continuous = continuous
        self.mz_dtype = np.dtype(mz_dtype)
        self.int_dtype = np.dtype(int_dtype)
        self._uuid = uuid_mod.uuid4()
        self._ibd = open(self.ibd_path, "wb")
        self._ibd.write(self._uuid.bytes)
        self._offset = 16
        self._shared_mz_ref: _ArrayRef | None = None
        self._entries: list[tuple[int, int, _ArrayRef, _ArrayRef]] = []

    def _write_array(self, data: np.ndarray, dtype: np.dtype) -> _ArrayRef:
        buf = np.ascontiguousarray(data, dtype=dtype).tobytes()
        self._ibd.write(buf)
        ref = _ArrayRef(offset=self._offset, length=len(data), dtype=dtype)
        self._offset += len(buf)
        return ref

    def add_spectrum(self, x: int, y: int, mzs: np.ndarray, ints: np.ndarray) -> None:
        if len(mzs) != len(ints):
            raise ValueError("mzs and ints must have equal length")
        if self.continuous:
            if self._shared_mz_ref is None:
                self._shared_mz_ref = self._write_array(mzs, self.mz_dtype)
            elif self._shared_mz_ref.length != len(mzs):
                raise ValueError("continuous mode requires identical m/z axes")
            mz_ref = self._shared_mz_ref
        else:
            mz_ref = self._write_array(mzs, self.mz_dtype)
        int_ref = self._write_array(ints, self.int_dtype)
        self._entries.append((x, y, mz_ref, int_ref))

    _DTYPE_CV = {
        np.dtype("<f4"): ('MS:1000521', '32-bit float'),
        np.dtype("<f8"): ('MS:1000523', '64-bit float'),
        np.dtype("<i4"): ('MS:1000519', '32-bit integer'),
        np.dtype("<i8"): ('MS:1000522', '64-bit integer'),
    }

    def close(self) -> None:
        self._ibd.close()
        mode_acc, mode_name = (
            (_CONTINUOUS, "continuous") if self.continuous else (_PROCESSED, "processed")
        )
        mz_cv, mz_cv_name = self._DTYPE_CV[self.mz_dtype]
        int_cv, int_cv_name = self._DTYPE_CV[self.int_dtype]
        xs = [e[0] for e in self._entries]
        ys = [e[1] for e in self._entries]
        out = []
        w = out.append
        w('<?xml version="1.0" encoding="ISO-8859-1"?>')
        w('<mzML xmlns="http://psi.hupo.org/ms/mzml" version="1.1">')
        w('  <cvList count="2">')
        w('    <cv id="MS" fullName="Proteomics Standards Initiative Mass Spectrometry Ontology"/>')
        w('    <cv id="IMS" fullName="Imaging MS Ontology"/>')
        w('  </cvList>')
        w('  <fileDescription><fileContent>')
        w(f'    <cvParam cvRef="IMS" accession="{mode_acc}" name="{mode_name}"/>')
        w(f'    <cvParam cvRef="IMS" accession="{_UUID}" name="universally unique identifier" '
          f'value="{{{self._uuid}}}"/>')
        w('  </fileContent></fileDescription>')
        w('  <referenceableParamGroupList count="2">')
        w('    <referenceableParamGroup id="mzArray">')
        w('      <cvParam cvRef="MS" accession="MS:1000514" name="m/z array"/>')
        w(f'      <cvParam cvRef="MS" accession="{mz_cv}" name="{mz_cv_name}"/>')
        w('    </referenceableParamGroup>')
        w('    <referenceableParamGroup id="intensityArray">')
        w('      <cvParam cvRef="MS" accession="MS:1000515" name="intensity array"/>')
        w(f'      <cvParam cvRef="MS" accession="{int_cv}" name="{int_cv_name}"/>')
        w('    </referenceableParamGroup>')
        w('  </referenceableParamGroupList>')
        w('  <scanSettingsList count="1"><scanSettings id="scan1">')
        w(f'    <cvParam cvRef="IMS" accession="IMS:1000042" name="max count of pixels x" '
          f'value="{max(xs) if xs else 0}"/>')
        w(f'    <cvParam cvRef="IMS" accession="IMS:1000043" name="max count of pixels y" '
          f'value="{max(ys) if ys else 0}"/>')
        w('  </scanSettings></scanSettingsList>')
        w('  <run id="run1">')
        w(f'  <spectrumList count="{len(self._entries)}">')
        for i, (x, y, mz_ref, int_ref) in enumerate(self._entries):
            w(f'    <spectrum id="spectrum={i}" index="{i}" defaultArrayLength="{mz_ref.length}">')
            w('      <scanList count="1"><scan>')
            w(f'        <cvParam cvRef="IMS" accession="{_POS_X}" name="position x" value="{x}"/>')
            w(f'        <cvParam cvRef="IMS" accession="{_POS_Y}" name="position y" value="{y}"/>')
            w('      </scan></scanList>')
            w('      <binaryDataArrayList count="2">')
            for group, ref in (("mzArray", mz_ref), ("intensityArray", int_ref)):
                w('        <binaryDataArray encodedLength="0">')
                w(f'          <referenceableParamGroupRef ref="{group}"/>')
                w(f'          <cvParam cvRef="IMS" accession="{_EXT_OFFSET}" '
                  f'name="external offset" value="{ref.offset}"/>')
                w(f'          <cvParam cvRef="IMS" accession="{_EXT_ARR_LEN}" '
                  f'name="external array length" value="{ref.length}"/>')
                w(f'          <cvParam cvRef="IMS" accession="IMS:1000104" '
                  f'name="external encoded length" value="{ref.length * ref.dtype.itemsize}"/>')
                w('          <binary/>')
                w('        </binaryDataArray>')
            w('      </binaryDataArrayList>')
            w('    </spectrum>')
        w('  </spectrumList>')
        w('  </run>')
        w('</mzML>')
        self.imzml_path.write_text("\n".join(out))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
