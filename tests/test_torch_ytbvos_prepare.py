"""The port's YouTube-VOS converter (``ivosw_tpu_torch/data/ytbvos_prepare.py``)
against the JAX package's on a copy of the committed source trees
(``train_demo/ytbvos_src``, ``ytbvos_scb``): the output trees, the
``scb_ytbvos.json`` registry file included, are byte-identical to each
other and to the committed ``train_demo/ytbvos_dst``."""

import os
import shutil

import pytest

from ivosw_tpu.data import ytbvos_prepare as jax_prepare
from ivosw_tpu_torch.data import ytbvos_prepare
from torch_dataset_trees import YTBVOS_DST, YTBVOS_SCB, YTBVOS_SRC, ytbvos_sequences


def _tree(root):
    """relative path → bytes of every file under ``root``."""
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            files[os.path.relpath(p, root)] = open(p, "rb").read()
    return files


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("ytbvos")
    shutil.copytree(YTBVOS_SRC, root / "src")
    shutil.copytree(YTBVOS_SCB, root / "scb")
    return str(root / "src"), str(root / "scb")


def test_converted_tree_is_the_jax_packages(tmp_path, sources):
    src, scb = sources
    for side, module in (("port", ytbvos_prepare), ("jax", jax_prepare)):
        seqs = module.create_dataset(src, str(tmp_path / side), scb)
        assert seqs == ytbvos_sequences()
        path = module.create_json(str(tmp_path / side))
        assert path == str(tmp_path / side / "scb_ytbvos.json")
    ours = _tree(tmp_path / "port")
    assert ours == _tree(tmp_path / "jax")
    assert len(ours) == 8 * (48 + 48 + 3) + 2  # frames, annotations, scribbles, val.txt, json
    assert ours == _tree(YTBVOS_DST)


def test_cli_and_sequence_info(tmp_path, sources):
    src, scb = sources
    ytbvos_prepare.main(["--src", src, "--scb", scb, "--dst", str(tmp_path / "dst")])
    assert _tree(tmp_path / "dst") == _tree(YTBVOS_DST)
    for seq in ytbvos_sequences():
        assert ytbvos_prepare.get_seq_info(str(tmp_path / "dst"), seq) == \
            jax_prepare.get_seq_info(YTBVOS_DST, seq)


def test_copies_keep_existing_files_and_missing_sources_raise(tmp_path, sources):
    src, scb = sources
    seq = ytbvos_sequences()[0]
    dst = tmp_path / "dst" / "JPEGImages" / "480p" / seq
    os.makedirs(dst)
    (dst / "00000.jpg").write_bytes(b"kept")
    n = ytbvos_prepare._copy_renumbered(os.path.join(src, "train", "JPEGImages", seq),
                                        str(dst), ".jpg")
    assert n == 48 and (dst / "00000.jpg").read_bytes() == b"kept"
    assert sorted(os.listdir(dst))[-1] == "00047.jpg"
    with pytest.raises(FileNotFoundError, match="JPEGImages directory not found"):
        ytbvos_prepare.create_dataset(str(tmp_path / "nowhere"), str(tmp_path / "d"), scb)
