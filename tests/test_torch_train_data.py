"""The port's training data (haff_tpu_torch/data/aff_dataset.py
`AffDataset`, loader.py, seg_datasets.py, extra_datasets.py) against
haff_tpu's on files the tests write: for a seed, the same sample
sequence byte for byte (images, masks, prompts, taxonomies), as
tests/test_data.py, test_seg_datasets.py and test_extra_datasets.py
write and read them."""

import json
import threading
import time

import numpy as np
import pytest

from haff_tpu.data import aff_dataset as JA
from haff_tpu.data import extra_datasets as JE
from haff_tpu.data import loader as JL
from haff_tpu.data import seg_datasets as JS
from haff_tpu_torch.data import aff_dataset as TA
from haff_tpu_torch.data import extra_datasets as TE
from haff_tpu_torch.data import loader as TL
from haff_tpu_torch.data import seg_datasets as TS

FIELDS = ("image", "question", "answer", "mask_left", "mask_right",
          "taxonomy", "turns")


def same_samples(a, b, n):
    """Draw n samples from each dataset; every field equal, arrays byte
    for byte with the same dtype."""
    for i in range(n):
        sa, sb = a[i], b[i]
        for f in FIELDS:
            x, y = getattr(sa, f), getattr(sb, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, (i, f)
                assert x.tobytes() == y.tobytes(), (i, f)
            else:
                assert x == y, (i, f, x, y)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every layout the datasets read, written once."""
    import cv2
    import h5py

    root = tmp_path_factory.mktemp("corpora")
    rng = np.random.RandomState(0)
    # 2HANDS shards: two h5 + json pairs, one range taken from its file
    sh = root / "shards"
    (sh / "h5").mkdir(parents=True)
    (sh / "jsons").mkdir()
    names = [b"open drawer", b"Cut Onion", b"pour water", b"wash plate",
             b"stir pot", b"lift lid"]
    for lo, hi, fname in ((0, 3, "0-3_P01.h5"), (4, 5, "P02_tail.h5")):
        n = hi - lo + 1
        with h5py.File(sh / "h5" / fname, "w") as f:
            g = f.create_group("data")
            g.create_dataset("inpainted", data=rng.randint(
                0, 255, (n, 48, 64, 3), np.uint8))
            g.create_dataset("narration", data=np.array(names[lo:hi + 1]))
            tax = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
            g.create_dataset("taxonomy", data=tax)
        entries = {}
        for i in range(lo, hi + 1):
            x, y = 5 + 3 * i, 4 + 2 * i
            square = [[[x, y]], [[x, y + 10]], [[x + 12, y + 10]],
                      [[x + 12, y]]]
            entries[str(i - lo)] = {
                "original_size": [48, 64],
                "aff_left": [square] if i % 2 else [],
                "aff_right": [] if i % 3 == 0 else [square]}
        (sh / "jsons" / fname.replace(".h5", ".json")).write_text(
            json.dumps(entries))
    # semantic segmentation (ADE-style folder)
    sem = root / "semseg"
    (sem / "images").mkdir(parents=True)
    (sem / "annotations").mkdir()
    for k in range(2):
        cv2.imwrite(str(sem / "images" / f"{k}.jpg"),
                    rng.randint(0, 255, (40, 60, 3)).astype(np.uint8))
        ann = np.zeros((40, 60), np.uint8)
        ann[5:20, 5:30] = 1 + k
        ann[25:35, 40:55] = 2
        cv2.imwrite(str(sem / "annotations" / f"{k}.png"), ann)
    # referring segmentation, with a gRefCOCO multi-ann and no-target ref
    ref = root / "refer"
    (ref / "images").mkdir(parents=True)
    cv2.imwrite(str(ref / "images" / "img1.jpg"),
                rng.randint(0, 255, (30, 50, 3)).astype(np.uint8))
    instances = {
        "images": [{"id": 10, "file_name": "img1.jpg", "height": 30,
                    "width": 50}],
        "annotations": [
            {"id": 100, "image_id": 10,
             "segmentation": [[5, 5, 20, 5, 20, 20, 5, 20]]},
            {"id": 101, "image_id": 10,
             "segmentation": {"counts": [40, 30, 1430], "size": [30, 50]}}],
        "categories": []}
    refs = [{"ref_id": 1, "ann_id": 100, "image_id": 10, "split": "train",
             "sentences": [{"sent": "the red mug"}, {"sent": "Left Mug"}]},
            {"ref_id": 2, "ann_id": [100, 101], "image_id": 10,
             "split": "train", "sentences": [{"sent": "both things"}]},
            {"ref_id": 3, "ann_id": [], "image_id": 10, "split": "train",
             "sentences": [{"sent": "the unicorn"}]},
            {"ref_id": 4, "ann_id": 100, "image_id": 10, "split": "val",
             "sentences": [{"sent": "held out"}]}]
    (ref / "instances.json").write_text(json.dumps(instances))
    (ref / "refs.json").write_text(json.dumps(refs))
    # ADE20K / COCO-Stuff / Mapillary layouts
    ade = root / "ade" / "ade20k"
    (ade / "images" / "training").mkdir(parents=True)
    (ade / "annotations" / "training").mkdir(parents=True)
    (ade / "ade20k_classes.json").write_text('["wall", "sky", "tree"]')
    lab = np.zeros((16, 16), np.uint8)
    lab[2:8, 2:8] = 2
    lab[9:14, 1:6] = 3
    lab[10:12, 10:12] = 255
    cv2.imwrite(str(ade / "images" / "training" / "a.jpg"),
                np.full((16, 16, 3), 100, np.uint8))
    cv2.imwrite(str(ade / "annotations" / "training" / "a.png"), lab)
    coco = root / "cs" / "cocostuff"
    (coco / "train2017").mkdir(parents=True)
    (coco / "cocostuff_classes.txt").write_text(
        "header\n0: person\n1: wall-brick\n2: sky\n")
    cl = np.zeros((8, 8), np.uint8)
    cl[:2] = 1
    cl[2:4] = 2
    cv2.imwrite(str(coco / "train2017" / "x.png"), cl)
    mapi = root / "mp" / "mapillary"
    (mapi / "training" / "v2.0" / "labels").mkdir(parents=True)
    (mapi / "config_v2.0.json").write_text(
        '{"labels": [{"readable": "Bird"}, {"readable": "Curb"}]}')
    cv2.imwrite(str(mapi / "training" / "v2.0" / "labels" / "f.png"),
                np.zeros((4, 4), np.uint8))
    # part segmentation (PACO-style COCO json)
    part = root / "part"
    (part / "imgs").mkdir(parents=True)
    cv2.imwrite(str(part / "imgs" / "i.jpg"), np.full((20, 20, 3), 9,
                                                      np.uint8))
    (part / "train.json").write_text(json.dumps({
        "images": [{"id": 1, "file_name": "i.jpg", "height": 20,
                    "width": 20}],
        "categories": [{"id": 7, "name": "car:wheel"},
                       {"id": 8, "name": "dog"}],
        "annotations": [
            {"id": 3, "image_id": 1, "category_id": 7,
             "segmentation": [[2, 2, 12, 2, 12, 12, 2, 12]],
             "bbox": [2, 2, 10, 10]},
            {"id": 4, "image_id": 1, "category_id": 8,
             "segmentation": [[13, 13, 18, 13, 18, 18, 13, 18]],
             "bbox": [13, 13, 5, 5]}]}))
    # ReasonSeg with explanations, and VQA
    rs = root / "reason"
    (rs / "train").mkdir(parents=True)
    (rs / "explanatory").mkdir()
    for k, (text, sent) in enumerate((("the largest cup", True),
                                      ("Red Mug", False))):
        cv2.imwrite(str(rs / "train" / f"{k}.jpg"),
                    rng.randint(0, 255, (40, 50, 3)).astype(np.uint8))
        (rs / "train" / f"{k}.json").write_text(json.dumps({
            "text": text, "is_sentence": sent, "shapes": [
                {"label": "target", "points": [[5, 5], [30, 5], [30, 20],
                                               [5, 20]]},
                {"label": "ignore", "points": [[32, 8], [45, 8], [45, 30],
                                               [32, 30]]}]}))
    (rs / "explanatory" / "train.json").write_text(json.dumps(
        [{"image": "0.jpg", "query": "q", "outputs": "Because reasons."}]))
    vqa = root / "vqa"
    (vqa / "imgs").mkdir(parents=True)
    cv2.imwrite(str(vqa / "imgs" / "x.jpg"),
                rng.randint(0, 255, (30, 30, 3)).astype(np.uint8))
    (vqa / "vqa.json").write_text(json.dumps([{
        "image": "x.jpg", "conversations": [
            {"from": "human", "value": "<image>\nWhat is this?"},
            {"from": "gpt", "value": "A kitchen."},
            {"from": "human", "value": "And that?"},
            {"from": "gpt", "value": "A pan."}]}]))
    return root


@pytest.mark.parametrize("seed", [0, 7])
def test_aff_dataset_byte_equal(files, seed):
    a = TA.AffDataset(str(files / "shards"), samples_per_epoch=8, seed=seed)
    b = JA.AffDataset(str(files / "shards"), samples_per_epoch=8, seed=seed)
    assert a.size == b.size == 6 and a.ranges == b.ranges and len(a) == 8
    assert a.original_size == b.original_size
    same_samples(a, b, 12)
    for i in range(6):  # each index directly
        same_samples([a.get(i)], [b.get(i)], 1)


def test_aff_dataset_hub_needs_datasets(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_datasets(name, *a, **kw):
        if name == "datasets":
            raise ImportError("No module named 'datasets'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="needs the `datasets` package"):
        TA.AffDataset("sjauhri/2HANDS-not-here")


def test_sem_seg_and_adapters_byte_equal(files):
    classes = ["background", "pan", "cup"]
    same_samples(TS.SemSegDataset(str(files / "semseg"), classes, seed=3),
                 JS.SemSegDataset(str(files / "semseg"), classes, seed=3), 10)
    ade = (TS.init_ade20k(str(files / "ade")), JS.init_ade20k(str(files / "ade")))
    assert ade[0] == ade[1]
    classes, images, labels = ade[0]
    lab = np.random.RandomState(0).randint(0, 256, (9, 9)).astype(np.uint8)
    assert np.array_equal(TS.ade20k_label_transform(lab),
                          JS.ade20k_label_transform(lab))
    same_samples(
        TS.SemSegDataset("", classes, image_paths=images, label_paths=labels,
                         label_transform=TS.ade20k_label_transform, seed=1),
        JS.SemSegDataset("", classes, image_paths=images, label_paths=labels,
                         label_transform=JS.ade20k_label_transform, seed=1), 6)
    cs = TS.init_cocostuff(str(files / "cs"))
    assert cs == JS.init_cocostuff(str(files / "cs"))
    lab = np.random.RandomState(1).randint(0, 4, (6, 6)).astype(np.uint8)
    assert np.array_equal(TS.make_cocostuff_label_transform(cs[0])(lab),
                          JS.make_cocostuff_label_transform(cs[0])(lab))
    assert (TS.init_mapillary(str(files / "mp"))
            == JS.init_mapillary(str(files / "mp")))
    for raw in ("dog", "dog_(canine):tail_(rear)", "car:wheel"):
        assert TS.part_name_phrases(raw) == JS.part_name_phrases(raw)


def test_refer_and_part_seg_byte_equal(files):
    r = files / "refer"
    a = TS.Refer(str(r / "refs.json"), str(r / "instances.json"))
    b = JS.Refer(str(r / "refs.json"), str(r / "instances.json"))
    for split in (None, "train", "val"):
        assert a.get_ref_ids(split) == b.get_ref_ids(split)
    for rid in (1, 2, 3, 4):
        ma, mb = a.get_mask(a.load_ref(rid)), b.get_mask(b.load_ref(rid))
        assert ma.dtype == mb.dtype and ma.tobytes() == mb.tobytes()
        assert a.image_file(a.load_ref(rid)) == b.image_file(b.load_ref(rid))
    args = (str(r / "refs.json"), str(r / "instances.json"), str(r / "images"))
    same_samples(TS.ReferSegDataset(*args, seed=5),
                 JS.ReferSegDataset(*args, seed=5), 12)
    p = files / "part"
    same_samples(TS.PartSegDataset(str(p / "train.json"), str(p / "imgs"),
                                   seed=2),
                 JS.PartSegDataset(str(p / "train.json"), str(p / "imgs"),
                                   seed=2), 10)


@pytest.mark.parametrize("explanatory", [-1.0, 0.5, 1.0])
def test_reason_seg_byte_equal(files, explanatory):
    import cv2

    img = cv2.imread(str(files / "reason" / "train" / "0.jpg"))
    ma, ta, sa = TE.get_mask_from_json(
        str(files / "reason" / "train" / "0.json"), img)
    mb, tb, sb = JE.get_mask_from_json(
        str(files / "reason" / "train" / "0.json"), img)
    assert ma.tobytes() == mb.tobytes() and (ta, sa) == (tb, sb)
    same_samples(
        TE.ReasonSegDataset(str(files / "reason"), seed=4,
                            explanatory=explanatory),
        JE.ReasonSegDataset(str(files / "reason"), seed=4,
                            explanatory=explanatory), 12)


def test_vqa_and_hybrid_byte_equal(files):
    v = files / "vqa"
    same_samples(TE.VqaDataset(str(v / "vqa.json"), str(v / "imgs"), seed=1),
                 JE.VqaDataset(str(v / "vqa.json"), str(v / "imgs"), seed=1),
                 3)

    def mix(E, S, A):
        return E.HybridDataset(
            [A.AffDataset(str(files / "shards"), seed=2),
             E.VqaDataset(str(v / "vqa.json"), str(v / "imgs"), seed=3),
             E.ReasonSegDataset(str(files / "reason"), seed=4),
             S.SemSegDataset(str(files / "semseg"), ["bg", "pan", "cup"],
                             seed=5)],
            [3, 1, 2, 2], samples_per_epoch=40, seed=9)

    a, b = mix(TE, TS, TA), mix(JE, JS, JA)
    assert len(a) == len(b) == 40
    same_samples(a, b, 30)


def test_prefetch_loader_sequence_equal_to_jax():
    """The same make_batch through the port's loader and JAX's, 1 and 3
    workers, batches completing out of order: the same ordered sequence."""
    def make_batch(i):
        time.sleep(0.002 * ((7 * i) % 5))
        return {"i": i, "x": np.full((2,), i)}

    for workers in (1, 3):
        got = list(TL.PrefetchLoader(make_batch, 17, num_workers=workers))
        want = list(JL.PrefetchLoader(make_batch, 17, num_workers=workers))
        assert [g["i"] for g in got] == [w["i"] for w in want] == list(
            range(17))


def test_prefetch_loader_window_and_error():
    """A worker error surfaces after the batches built before it; the
    worker threads run at most prefetch + workers batches ahead."""
    built, lock = [], threading.Lock()

    def make_batch(i):
        with lock:
            built.append(i)
        if i == 5:
            raise ValueError("bad sample 5")
        return {"i": i}

    loader = TL.PrefetchLoader(make_batch, 10, prefetch=1, num_workers=2)
    it = iter(loader)
    first = next(it)
    time.sleep(0.05)
    assert first["i"] == 0 and max(built) <= 1 + 1 + 2
    got = [first["i"]]
    with pytest.raises(ValueError, match="bad sample 5"):
        for b in it:
            got.append(b["i"])
    assert got == [0, 1, 2, 3, 4]
