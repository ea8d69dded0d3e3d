"""TSV datasets, GLIP's large-scale pretraining format (host copy of
`lpi_tpu/data/tsv.py`).

Images are stored one a row as `key \\t base64(jpeg) [\\t ...]`, read at
random through a `.lineidx` sidecar of byte offsets; labels sit in a
parallel TSV of `key \\t json`; an optional linelist file picks rows;
`CompositeTSVFile` puts a list of shard TSVs behind one index. Host IO
only: annotations come back as plain dicts. PyYAML is imported only by
`TSVDataset.from_yaml`.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import List, Optional, Sequence


def _load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def create_lineidx(tsv_path: str, idx_path: Optional[str] = None) -> str:
    """Write the byte offset of every row. -> the sidecar's path."""
    idx_path = idx_path or os.path.splitext(tsv_path)[0] + ".lineidx"
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(idx_path, "w") as f:
        f.writelines(f"{o}\n" for o in offsets)
    return idx_path


def load_linelist_file(path: Optional[str]) -> Optional[List[int]]:
    if path is None:
        return None
    with open(path) as f:
        return [int(line.strip()) for line in f if line.strip()]


def img_from_base64(s: str):
    """-> a PIL RGB image, or None for a corrupt row."""
    from PIL import Image

    try:
        return Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB")
    except Exception:
        return None


class TSVFile:
    """Random access to a TSV's rows through its .lineidx sidecar (written
    when missing and `generate_lineidx`)."""

    def __init__(self, tsv_file: str, generate_lineidx: bool = False):
        self.tsv_file = tsv_file
        self.lineidx = os.path.splitext(tsv_file)[0] + ".lineidx"
        if not os.path.isfile(self.lineidx) and generate_lineidx:
            create_lineidx(tsv_file, self.lineidx)
        self._offsets: Optional[List[int]] = None
        self._fp = None

    def _ensure(self):
        if self._offsets is None:
            with open(self.lineidx) as f:
                self._offsets = [int(l.strip()) for l in f if l.strip()]
        if self._fp is None:
            self._fp = open(self.tsv_file, "r")

    def num_rows(self) -> int:
        self._ensure()
        return len(self._offsets)

    def seek(self, idx: int) -> List[str]:
        self._ensure()
        self._fp.seek(self._offsets[idx])
        return [c.strip() for c in self._fp.readline().split("\t")]

    def get_key(self, idx: int) -> str:
        return self.seek(idx)[0]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def __len__(self) -> int:
        return self.num_rows()

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class CompositeTSVFile:
    """Shard TSVs behind one sequence of (shard index, row index)."""

    def __init__(self, file_list: Sequence[str], seq: Sequence[tuple], root: str = "."):
        self.tsvs = [TSVFile(os.path.join(root, f)) for f in file_list]
        self.seq = list(seq)

    def __getitem__(self, index: int) -> List[str]:
        shard, row = self.seq[index]
        return self.tsvs[int(shard)].seek(int(row))

    def get_key(self, index: int) -> str:
        return self[index][0]

    def __len__(self) -> int:
        return len(self.seq)


class TSVDataset:
    """An image TSV with an optional label TSV and linelist. `ds[i]` ->
    (PIL image, annotations dict or None, key); a label row's json that is
    a bare list (detection boxes) becomes {"objects": list}."""

    def __init__(self, img_file: str, label_file: Optional[str] = None,
                 linelist_file: Optional[str] = None):
        self.img_tsv = TSVFile(img_file, generate_lineidx=True)
        self.label_tsv = TSVFile(label_file, generate_lineidx=True) if label_file else None
        self.line_list = load_linelist_file(linelist_file)

    @classmethod
    def from_yaml(cls, yaml_file: str, root: Optional[str] = None) -> "TSVDataset":
        """From a shard descriptor: a yaml with `img` and optional `label`
        and `linelist` keys, paths relative to the yaml's directory (or
        `root`)."""
        cfg = _load_yaml(yaml_file)
        base = root or os.path.dirname(yaml_file)

        def find(fname):
            if fname is None:
                return None
            return fname if os.path.isfile(fname) else os.path.join(base, fname)

        return cls(find(cfg["img"]), find(cfg.get("label")), find(cfg.get("linelist")))

    def __len__(self):
        return len(self.line_list) if self.line_list is not None else self.img_tsv.num_rows()

    def _row(self, index: int) -> int:
        return self.line_list[index] if self.line_list is not None else index

    def __getitem__(self, index: int):
        row = self._row(index)
        cols = self.img_tsv.seek(row)
        key = cols[0]
        img = img_from_base64(cols[-1])
        anns = None
        if self.label_tsv is not None:
            lcols = self.label_tsv.seek(row)
            assert lcols[0] == key, f"label/img key mismatch at row {row}"
            anns = json.loads(lcols[1])
            if isinstance(anns, list):
                anns = {"objects": anns}
        return img, anns, key


def write_tsv(path: str, rows: Sequence[Sequence[str]]) -> str:
    """Write the rows and their lineidx. -> `path`."""
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(row) + "\n")
    create_lineidx(path)
    return path
