"""Named dataset catalog (host copy of `lpi_tpu/data/catalog.py`), the
reference's `config/paths_catalog.py` surface.

The reference resolves every dataset by name through `DatasetCatalog.get`,
with relative paths located by `try_to_find` (the working directory, then
`$DATASET`, then a fixed search path) and ad-hoc names added at run time
through `cfg.DATASETS.REGISTER` (how every ODinW yaml wires its splits).
Here:

* the built-in name table: the RefExp, RefExp+ and RefCOCOg splits,
  flickr30k, mixed VG+COCO, gqa, phrasecut, the coco/lvis/object365/vg/
  openimages/imagenet-od TSV trains and the coco_grounding/lvis json
  detection sets;
* `register()` for runtime names and `register_odinw()`, which expands one
  ODinW dataset directory into its conventional split names;
* `build()`, onto the port's loaders: `load_mdetr_refexp` (mdetr kind),
  `load_coco_detection` (coco kind) and `TSVDataset` (tsv kind).

Where the reference exits on a missing file, `try_to_find` raises
FileNotFoundError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

# factory-name -> loader kind. Mirrors the reference's factory strings
# (`paths_catalog.py:282-443`); several torch Dataset classes collapse onto
# one loader because they differ only in torch plumbing.
_MDETR_FACTORIES = {
    "RefExpDataset", "GQADataset", "MixedDataset", "FlickrDataset",
    "PhrasecutDetection", "ModulatedDataset",
}
_COCO_FACTORIES = {"CocoGrounding", "COCODataset", "LvisDetection",
                   "Background"}
_TSV_FACTORIES = {"CaptionTSV", "CocoDetectionTSV", "ODTSVDataset",
                  "PseudoData"}

DEFAULT_SEARCH_PATH = ["./DATASET", "./OUTPUT", "./data", "./MODEL"]


def try_to_find(file: str, return_dir: bool = False,
                search_path: Optional[List[str]] = None) -> str:
    """Path resolution of `paths_catalog.py:try_to_find` (raises instead of
    exiting)."""
    if not file:
        return file
    if file.startswith("catalog://"):
        return file
    candidates = ["./"]
    if "DATASET" in os.environ:
        candidates.append(os.environ["DATASET"])
    candidates += search_path if search_path is not None else DEFAULT_SEARCH_PATH
    for path in candidates:
        if os.path.exists(os.path.join(path, file)):
            return path if return_dir else os.path.join(path, file)
    raise FileNotFoundError(f"Cannot find {file} in {candidates}")


@dataclasses.dataclass
class DatasetSpec:
    name: str
    factory: str
    ann_file: str = ""
    img_dir: str = ""
    is_train: bool = False
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def kind(self) -> str:
        if self.factory in _MDETR_FACTORIES:
            return "mdetr"
        if self.factory in _COCO_FACTORIES:
            return "coco"
        if self.factory in _TSV_FACTORIES:
            return "tsv"
        raise KeyError(f"unknown dataset factory {self.factory!r}")


def _mdetr(name, ann, img, train=False, factory="RefExpDataset", **extra):
    return DatasetSpec(name, factory, ann, img, train, extra)


_D = "mdetr_annotations"
_BUILTIN: Dict[str, DatasetSpec] = {}
for _n, _s in {
    # pretrain mixed VG+COCO (`paths_catalog.py:33-43`)
    "mixed_train": _mdetr("mixed_train", f"{_D}/final_mixed_train.json",
                          "gqa/images", True, "MixedDataset",
                          coco_img_dir="coco/train2014"),
    "mixed_train_no_coco": _mdetr(
        "mixed_train_no_coco", f"{_D}/final_mixed_train_no_coco.json",
        "gqa/images", True, "MixedDataset", coco_img_dir="coco/train2014"),
    # flickr30k grounding
    "flickr30k_train": _mdetr(
        "flickr30k_train", f"{_D}/final_flickr_separateGT_train.json",
        "flickr30k/flickr30k_images/train", True, "FlickrDataset"),
    "flickr30k_val": _mdetr(
        "flickr30k_val", f"{_D}/final_flickr_separateGT_val.json",
        "flickr30k/flickr30k_images/val", False, "FlickrDataset"),
    "flickr30k_test": _mdetr(
        "flickr30k_test", f"{_D}/final_flickr_separateGT_test.json",
        "flickr30k/flickr30k_images/test", False, "FlickrDataset"),
    # refcoco / refcoco+ / refcocog (the LPI continual splits)
    "refexp_all_val": _mdetr("refexp_all_val", f"{_D}/final_refexp_val.json",
                             "refcoco/train2014"),
    # gqa / phrasecut
    "gqa_val": _mdetr("gqa_val", f"{_D}/final_gqa_val.json", "gqa/images",
                      False, "GQADataset"),
    "phrasecut_train": _mdetr(
        "phrasecut_train", f"{_D}/finetune_phrasecut_train.json",
        "gqa/images", True, "PhrasecutDetection"),
    # COCO-format detection jsons
    "coco_grounding_train": DatasetSpec(
        "coco_grounding_train", "CocoGrounding",
        "coco/annotations/instances_train2017.json", "coco/train2017", True),
    "lvis_grounding_train": DatasetSpec(
        "lvis_grounding_train", "LvisDetection",
        "coco/annotations/lvis_od_train.json", "coco"),
    "lvis_val": DatasetSpec("lvis_val", "LvisDetection",
                            "coco/annotations/lvis_od_val.json", "coco"),
}.items():
    _BUILTIN[_n] = _s

for _prefix, _file in (("refexp", "refcoco"), ("refexp_+", "refcoco+"),
                       ("refexp_g", "refcocog")):
    _splits = ("train", "val", "testA", "testB") if _file != "refcocog" \
        else ("train", "val", "test")
    for _sp in _splits:
        _n = f"{_prefix}_{_sp}"
        _BUILTIN[_n] = _mdetr(_n, f"{_D}/finetune_{_file}_{_sp}.json",
                              "coco/train2014", _sp == "train")

# TSV pipelines (`paths_catalog.py:143-215`): name -> (factory, yaml shard
# descriptor). The yaml_path points at the shard config consumed by
# `data/tsv.py` (image tsv + label tsv + optional linelist).
for _n, (_f, _y, _tr) in {
    "coco_dt_train": ("CocoDetectionTSV", "coco_tsv/coco_obj.yaml", True),
    "COCO_odinw_train_8copy_dt_train":
        ("CocoDetectionTSV", "coco_tsv/COCO_odinw_train_8copy.yaml", True),
    "COCO_odinw_val_dt_train":
        ("CocoDetectionTSV", "coco_tsv/COCO_odinw_val.yaml", False),
    "lvisv1_dt_train": ("CocoDetectionTSV", "coco_tsv/LVIS_v1_train.yaml", True),
    "LVIS_odinw_train_8copy_dt_train":
        ("CocoDetectionTSV", "coco_tsv/LVIS_odinw_train_8copy.yaml", True),
    "object365_dt_train":
        ("CocoDetectionTSV", "Objects365/objects365_train_vgoiv6.cas2000.yaml", True),
    "object365_odinw_2copy_dt_train":
        ("CocoDetectionTSV", "Objects365/objects365_train_odinw.cas2000_2copy.yaml", True),
    "objects365_odtsv_train": ("ODTSVDataset", "Objects365/train.cas2000.yaml", True),
    "objects365_odtsv_val": ("ODTSVDataset", "Objects365/val.yaml", False),
    "imagenetod_train_odinw_2copy_dt":
        ("CocoDetectionTSV", "imagenet_od/imagenetod_train_odinw_2copy.yaml", True),
    "oi_train_odinw_dt":
        ("CocoDetectionTSV", "openimages_v5c/oi_train_odinw.cas.2000.yaml", True),
    "vg_dt_train": ("CocoDetectionTSV", "visualgenome/train_vgoi6_clipped.yaml", True),
    "vg_odinw_clipped_8copy_dt_train":
        ("CocoDetectionTSV", "visualgenome/train_odinw_clipped_8copy.yaml", True),
    "vg_vgoi6_clipped_8copy_dt_train":
        ("CocoDetectionTSV", "visualgenome/train_vgoi6_clipped_8copy.yaml", True),
}.items():
    _BUILTIN[_n] = DatasetSpec(_n, _f, is_train=_tr, extra={"yaml_path": _y})

# ODinW benchmark membership (`configs/odinw_13/`, `configs/odinw_35/`).
ODINW_13 = [
    "AerialMaritimeDrone_large", "Aquarium", "CottontailRabbits",
    "EgoHands_generic", "NorthAmericaMushrooms", "Packages", "PascalVOC",
    "Raccoon", "ShellfishOpenImages", "VehiclesOpenImages", "pistols",
    "pothole", "thermalDogsAndPeople",
]
ODINW_35 = ODINW_13 + [
    "AerialMaritimeDrone_tiled", "AmericanSignLanguageLetters", "BCCD",
    "ChessPieces", "DroneControl", "EgoHands_specific", "HardHatWorkers",
    "MaskWearing", "MountainDewCommercial", "OxfordPets_by-breed",
    "OxfordPets_by-species", "PKLot", "ThermalCheetah", "UnoCards",
    "WildfireSmoke", "boggleBoards", "brackishUnderwater", "dice",
    "openPoetryVision", "plantdoc_100x100", "plantdoc_416x416",
    "selfdrivingCar", "websiteScreenshots",
]


class DatasetCatalog:
    """Name -> DatasetSpec registry with runtime registration."""

    def __init__(self):
        self._specs: Dict[str, DatasetSpec] = dict(_BUILTIN)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def names(self) -> List[str]:
        return sorted(self._specs)

    def register(self, name: str, ann_file: str, img_dir: str = "",
                 is_train: bool = False, factory: str = "CocoGrounding",
                 **extra) -> DatasetSpec:
        """`cfg.DATASETS.REGISTER` parity (`data/build.py:292-306`)."""
        spec = DatasetSpec(name, factory, ann_file, img_dir, is_train, extra)
        self._specs[name] = spec
        return spec

    def register_odinw(self, dataset: str, root: str = "odinw",
                       shots=(1, 3, 5, 10), seeds=(3, 30, 300)) -> List[str]:
        """Expand one ODinW dataset dir into its conventional split names
        (the REGISTER block every `configs/odinw_*/<dataset>.yaml` carries)."""
        base = f"{root}/{dataset}"
        names = []
        for split in ("train", "val", "test"):
            n = f"odinw_{dataset}_{split}"
            self.register(n, f"{base}/{split}/annotations_without_background.json",
                          f"{base}/{split}", split == "train")
            names.append(n)
        for shot in shots:
            for seed in seeds:
                n = f"odinw_{dataset}_train_{shot}_{seed}"
                self.register(
                    n, f"{base}/train/fewshot_train_shot{shot}_seed{seed}.json",
                    f"{base}/train", True)
                names.append(n)
        return names

    def get(self, name: str) -> DatasetSpec:
        if name not in self._specs:
            raise KeyError(
                f"unknown dataset {name!r}; known: {self.names()[:8]}...")
        return self._specs[name]

    def build(self, name: str, tokenizer=None, task_id: int = 0,
              search_path: Optional[List[str]] = None, copies: int = 1,
              **loader_kw):
        """Resolve paths and construct the loader for `name`.

        mdetr/coco kinds -> GroundingTaskSet; tsv kind -> TSVDataset.
        `copies` applies DATASETS.GENERAL_COPY duplication (ODinW fewshot).
        """
        spec = self.get(name)
        if spec.kind == "tsv":
            from lpi_tpu_torch.data.tsv import TSVDataset
            yaml_path = try_to_find(spec.extra["yaml_path"],
                                    search_path=search_path)
            return TSVDataset.from_yaml(yaml_path, **loader_kw)
        ann = try_to_find(spec.ann_file, search_path=search_path)
        img = try_to_find(spec.img_dir, search_path=search_path) \
            if spec.img_dir else ""
        if spec.kind == "mdetr":
            from lpi_tpu_torch.data.grounding import load_mdetr_refexp
            ds = load_mdetr_refexp(ann, img, task_id=task_id,
                                   tokenizer=tokenizer, **loader_kw)
        else:
            from lpi_tpu_torch.data.grounding import load_coco_detection
            ds = load_coco_detection(ann, img, tokenizer=tokenizer,
                                     **loader_kw)
        return ds.duplicated(copies) if copies > 1 else ds


CATALOG = DatasetCatalog()
