"""Runtime policy (utils/runtime.py), the PNG writer, and the on-card
smoke script's refusal to run without a GPU."""
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

import chip_smoke
from esn_tpu.data.palettes import save_predict, write_png
from esn_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decode_png(path):
    """(IHDR fields, pixel rows) of an 8-bit filter-0 PNG, via zlib."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    assert b"IEND" in chunks
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[b"IHDR"])
    ch = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * ch)
    assert depth == 8 and interlace == 0 and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, ch)


@pytest.mark.parametrize("shape", [(5, 7), (6, 9, 3)], ids=["grey", "rgb"])
def test_write_png_decodes_back(rng, tmp_path, shape):
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    got = _decode_png(path)
    np.testing.assert_array_equal(got.reshape(shape), img)


def test_save_predict_writes_label_ids_and_colours(tmp_path):
    pred = np.array([[0, 1], [18, 255]], np.uint8)
    save_predict(pred, pred, "a/b.png", "cityscapes", str(tmp_path),
                 output_grey=True, output_color=True, gt_color=True)
    grey = _decode_png(str(tmp_path / "b.png"))[..., 0]
    np.testing.assert_array_equal(grey, [[7, 8], [33, 0]])   # label IDs
    assert _decode_png(str(tmp_path / "b_color.png")).shape == (2, 2, 3)
    assert os.path.exists(tmp_path / "b_gt.png")


@pytest.mark.parametrize("backend,dtype", [("cpu", "float32"),
                                           ("gpu", "bfloat16")])
def test_default_compute_dtype(backend, dtype):
    assert runtime.default_compute_dtype(backend) == dtype


@pytest.mark.parametrize("environ,backend,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "gpu", None),
    ({}, "gpu", runtime.REPO_CACHE_DIR),
    ({}, "cpu", None),
], ids=["env-set", "env-unset", "cpu"])
def test_compile_cache_dir(environ, backend, want):
    assert runtime.compile_cache_dir(environ, backend) == want


def test_repo_cache_dir_is_fixed_and_ignored():
    assert runtime.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    """Alone in a directory, the script finds no program and fails before
    touching JAX."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
