"""The roofline counts against values worked by hand."""

import json
import math

import pytest

from tiny import ROOT
from benchmark import roofline


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_offline_song_chunk_by_hand():
    # 2^21 samples; buckets (block, hop): 65536/16384, 16384/4096, 4096/1024,
    # 1024/256, 256/64 -> 128, 512, 2048, 8192, 32768 frames; five FFTs of
    # 2.5 B log2 B a frame.
    n = 2**21
    by_hand = 12.5 * (128 * 65536 * 16 + 512 * 16384 * 14 + 2048 * 4096 * 12 + 8192 * 1024 * 10 + 32768 * 256 * 8)
    r = roofline.offline_file(cfg("offline_44k_6band"), n)
    assert r["flops"] == pytest.approx(by_hand) == pytest.approx(6.2915e9, rel=1e-4)
    assert r["bytes"] == 20 * n
    assert r["bound"] == "operations"
    assert r["seconds"] == pytest.approx(by_hand / 67e12)


def test_offline_odd_length_counts_ceil_frames():
    n = 44100
    frames = [math.ceil(n / h) for h in (16384, 4096, 1024, 256, 64)]
    by_hand = 12.5 * sum(f * b * math.log2(b) for f, b in zip(frames, (65536, 16384, 4096, 1024, 256)))
    assert roofline.offline_file(cfg("offline_44k_6band"), n)["flops"] == pytest.approx(by_hand)


def test_pool_block_by_hand():
    # 2048 streams, hw 2048; buckets 8192/2048 (1 frame a block), 4096/1024
    # (2), 1024/256 (8), 256/64 (32).  State a stream: history 2 x 4 x 2048,
    # carries 3 x (8192 + 4096 + 1024 + 256) samples, a 4-byte counter; read
    # and written.  Block: 2 channels in, 3 stems out.
    s = 2048
    flops = s * 12.5 * (8192 * 13 + 2 * 4096 * 12 + 8 * 1024 * 10 + 32 * 256 * 8)
    state = (2 * 4 * 2048 + 3 * (8192 + 4096 + 1024 + 256)) * 4 + 4
    nbytes = s * (5 * 2048 * 4 + 2 * state)
    r = roofline.pool_block(cfg("stream_48k_4band_bela"), s)
    assert r["flops"] == pytest.approx(flops) == pytest.approx(9.0177e9, rel=1e-4)
    assert r["bytes"] == nbytes == 2048 * 497672
    assert r["bound"] == "bytes"
    assert r["seconds"] == pytest.approx(nbytes / 3.35e12)
    assert roofline.pool_block(cfg("stream_48k_4band_bela"), 8192)["seconds"] == pytest.approx(4 * r["seconds"])
