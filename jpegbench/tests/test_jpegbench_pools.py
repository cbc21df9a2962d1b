"""The pool's images from a configuration: the four cells' pools of one
size stay what they were before class lists came (their spec dicts and
cache files, pinned), and a class list cycles its classes in their counts."""

import hashlib
import json
import os

import pytest

from jpegbench import harness as H
from jpegbench.tests.tiny import LARGE, MIXED_CONFIG, tiny_config

# (config, traffic, seed) -> (sha256 of the spec dicts, first 32 hex digits;
# the pool's cache file), as the harness made them with width/height alone.
PINNED = {
    ("corpus_2048", "stream_420", 7): ("bf41ac0a05bd8e985e267ecc14532d30", "bd6c60256e2ac207c2d64761326cb935.pkl"),
    ("corpus_2048", "stream_420", 3000000019): ("0be7fd3a091fe27a20989a5916b2c8e9", "82405d0df5eefba3241f82334a984c30.pkl"),
    ("corpus_2048", "stream_prog", 7): ("63957394e64e94f56910cc81d58283a4", "819b695214bec87536e73db950ae5569.pkl"),
    ("corpus_2048", "stream_prog", 3000000019): ("38c2bf4bfe3dee340e91761e5b0c14e4", "3751a5e278d4969daeb1dac80d51b5d0.pkl"),
    ("uploads_4k", "uploads_rst", 7): ("011b29ee8ffd3d2d786d797278185e73", "d98c0bac72cbe727e58c0a321cd7402a.pkl"),
    ("uploads_4k", "uploads_rst", 3000000019): ("d39756167850e52dd7388f382380e533", "daa1c19abccddf9ee1627daefc382631.pkl"),
    ("uploads_4k", "uploads_norst", 7): ("84833e84e3e6a7dc61eaea6b626eed32", "df57d36785bdf73e8f579b5ac68428a0.pkl"),
    ("uploads_4k", "uploads_norst", 3000000019): ("2084ca1aa88e8fea67d7277aa11a6d2c", "f1fd940dd91856c5e33472e5f6c6f9d7.pkl"),
}
SPEC_KEYS = {"w", "h", "seed", "quality", "sampling", "progressive", "restart_blocks", "kind"}


def _traffic(name):
    with open(H.traffic_file(name)) as f:
        return json.load(f)


@pytest.mark.parametrize("config,traffic,seed", sorted(PINNED))
def test_the_cells_pools_are_pinned(config, traffic, seed):
    cfg = H.load_json(H.ROOT, f"jpegbench/configs/{config}.json")
    specs = H.pool_specs(cfg, _traffic(traffic), seed)
    assert len(specs) == cfg["pool"] and all(set(s) == SPEC_KEYS for s in specs)
    digest = hashlib.sha256(json.dumps(specs, sort_keys=True).encode()).hexdigest()[:32]
    assert (digest, os.path.basename(H.pool_path(specs, "/checkout"))) == PINNED[config, traffic, seed]


def test_a_class_list_cycles_its_classes_in_their_counts():
    cfg = dict(MIXED_CONFIG, pool=23)
    specs = H.pool_specs(cfg, _traffic("uploads_norst"), 11)
    cycle = [(512, 512)] * 4 + [(768, 512)] * 3 + [(1024, 1024)] * 2 + [(2048, 2048)]
    assert [(s["w"], s["h"]) for s in specs] == [cycle[i % 10] for i in range(23)]
    assert all(set(s) == SPEC_KEYS and s["restart_blocks"] == 0 and s["quality"] == 85 for s in specs)
    # Pixel seeds from (seed, index), whatever the class.
    one_size = dict(cfg, width=64, height=48)
    del one_size["images"]
    assert [s["seed"] for s in specs] == [s["seed"] for s in H.pool_specs(one_size, _traffic("uploads_norst"), 11)]


def test_every_size_meets_every_sampling_by_turns():
    # A cycle of even length would give a size one sampling alone if the
    # sampling went by the pool's index; it goes by the size's own turn.
    cfg = dict(MIXED_CONFIG, pool=40, sampling=["4:2:2", "4:4:4"])
    specs = H.pool_specs(cfg, _traffic("uploads_norst"), 11)
    for w, h in {(s["w"], s["h"]) for s in specs}:
        turns = [s["sampling"] for s in specs if (s["w"], s["h"]) == (w, h)]
        assert turns == [cfg["sampling"][k % 2] for k in range(len(turns))]


@pytest.mark.parametrize("drop", [None, "images"])
def test_a_configuration_gives_one_form_of_sizes(drop):
    cfg = dict(MIXED_CONFIG, width=64, height=48)
    if drop:
        del cfg[drop], cfg["width"], cfg["height"]
    with pytest.raises(ValueError):
        H.pool_specs(cfg, _traffic("stream_420"), 1)


def test_an_empty_class_list_or_a_malformed_class_is_refused():
    first = MIXED_CONFIG["images"][0]
    for images in ([], [dict(first, count=0)], [dict(first, quality=90)]):
        with pytest.raises(ValueError):
            H.image_cycle(dict(MIXED_CONFIG, images=images))


def test_the_tiny_cut_of_a_class_list():
    cut = tiny_config(MIXED_CONFIG)
    sizes = [(c["width"], c["height"]) for c in cut["images"]]
    assert sizes == [(40, 30), (48, 36), (56, 42), LARGE] and len(set(sizes)) == len(sizes)
    assert [c["count"] for c in cut["images"]] == [4, 3, 2, 1]
    assert cut["pool"] == 10 and MIXED_CONFIG["images"][0]["width"] == 512
