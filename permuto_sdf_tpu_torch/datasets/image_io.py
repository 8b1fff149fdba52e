"""PNG files with numpy and the standard library's ``zlib`` (the port's
counterpart of the ``imageio`` calls of the JAX package's loaders,
``datasets/dtu.py`` and ``experiments/run_custom_dataset.py``).

:func:`read_png` reads 8-bit grey, grey + alpha, RGB and RGBA images
(colour types 0, 4, 2 and 6), not interlaced, with any of the five row
filters, into the arrays ``imageio.imread`` gives: uint8 ``[H, W]`` for
grey, ``[H, W, C]`` otherwise (ancillary chunks such as ``tRNS`` are
ignored, as there). It refuses 16-bit samples, palettes and interlacing
with ``NotImplementedError`` (ROADMAP Queue 1, the image formats item), and
JPEG files likewise.

The Average and Paeth filters predict a byte from its left neighbour in
the same row, so a row cannot be undone with one vector operation. The
decoder walks the anti-diagonals instead: pixel ``(y, x)`` needs only
``(y, x - 1)``, ``(y - 1, x)`` and ``(y - 1, x - 1)``, which all lie on
the two diagonals before its own, so each of the ``H + W - 1`` steps undoes
one whole diagonal at once, every row with its own filter.

:func:`write_png` writes 8-bit grey or RGB with every row Paeth-filtered
(the hardest filter to undo, so the port's own scenes exercise the
diagonal walk).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_BATCH = 8  # images of one shape undone in one diagonal walk
_UNSUPPORTED = ("16-bit samples, palettes (colour type 3) and interlaced files are not read "
                "yet (ROADMAP Queue 1, the image formats item)")


def _chunks(data: bytes, path: str):
    """-> [(type, payload)] of a PNG byte string, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, out = 8, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        out.append((kind, payload))
        pos += 12 + length
        if kind == b"IEND":
            return out
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays (left, up, up-left)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _skewed(a: np.ndarray, h: int, w: int, k0: int = 0, y0: int = 0) -> np.ndarray:
    """The [H, W, ...] view of ``a`` [K, Y, ...] whose element (y, x) is
    ``a[k0 + y + x, y0 + y]``: pixel (y, x) on its anti-diagonal."""
    s0, s1 = a.strides[:2]
    base = a[k0:, y0:]
    return np.lib.stride_tricks.as_strided(base, (h, w) + a.shape[2:],
                                           (s0 + s1, s0) + a.strides[2:])


def _unfilter(rows: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the row filters of N images of one shape at once: ``rows``
    [N, H, 1 + W * bpp] uint8 (each row's filter byte first) -> [N, H, W,
    bpp] uint8, one anti-diagonal of every image a step."""
    ftype = rows[:, :, 0].T[:, :, None]  # [H, N, 1]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())} does not exist")
    n = rows.shape[0]
    # diagonal k = y + x holds row y at [k, y]; recon is shifted by two
    # diagonals and one row, so out-of-image neighbours read its zeros
    diag = np.zeros((h + w - 1, h, n, bpp), np.int16)
    _skewed(diag, h, w)[...] = rows[:, :, 1:].reshape(n, h, w, bpp).transpose(1, 2, 0, 3)
    recon = np.zeros((h + w + 1, h + 1, n, bpp), np.int16)
    masks = {t: ftype == t for t in (1, 2, 3, 4) if (ftype == t).any()}
    whole = len(masks) == 1 and next(iter(masks.values())).all()  # one filter everywhere
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(h, k + 1)
        a = recon[k + 1, lo + 1:hi + 1]  # (y, x - 1)
        b = recon[k + 1, lo:hi]  # (y - 1, x)
        c = recon[k, lo:hi]  # (y - 1, x - 1)
        pred = 0
        for t, m in masks.items():
            p = a if t == 1 else b if t == 2 else (a + b) >> 1 if t == 3 else _paeth(a, b, c)
            pred = p if whole else np.where(m[lo:hi], p, pred)
        recon[k + 2, lo + 1:hi + 1] = (diag[k, lo:hi] + pred) & 255
    return _skewed(recon, h, w, 2, 1).transpose(2, 0, 1, 3).astype(np.uint8)


def _header(path: str):
    """-> (IHDR fields (w, h, bpp), the zlib stream) of a PNG file."""
    with open(path, "rb") as f:
        chunks = _chunks(f.read(), path)
    if chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace {interlace}: "
            f"{_UNSUPPORTED}")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} or filter method {filt}")
    return (w, h, _CHANNELS[ctype]), b"".join(p for k, p in chunks if k == b"IDAT")


def read_pngs(paths) -> list:
    """8-bit PNG files -> uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4)
    each, in order. Files of one shape are undone together, up to
    ``_BATCH`` in one diagonal walk. A ``.jpg``/``.jpeg`` path raises
    ``NotImplementedError``."""
    for p in paths:
        if os.path.splitext(p)[1].lower() in (".jpg", ".jpeg"):
            raise NotImplementedError(
                f"{p}: JPEG images are not read yet (ROADMAP Queue 1, the image formats "
                "item); convert the scene to 8-bit PNG")
    heads = [_header(p) for p in paths]
    groups: dict = {}
    for i, (shape, _) in enumerate(heads):
        groups.setdefault(shape, []).append(i)
    out = [None] * len(paths)
    for (w, h, bpp), idx in groups.items():
        for s in range(0, len(idx), _BATCH):
            part = idx[s:s + _BATCH]
            rows = []
            for i in part:
                raw = zlib.decompress(heads[i][1])
                if len(raw) != h * (1 + w * bpp):
                    raise ValueError(f"{paths[i]}: {len(raw)} bytes of image data for "
                                     f"{w}x{h}x{bpp}")
                rows.append(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp))
            for i, img in zip(part, _unfilter(np.stack(rows), h, w, bpp)):
                out[i] = img[..., 0] if bpp == 1 else img
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG file -> uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4)."""
    return read_pngs([path])[0]


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray):
    """Write uint8 [H, W] (grey), [H, W, 1] (grey) or [H, W, 3] (RGB) as an
    8-bit PNG, every row Paeth-filtered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"write_png takes [H, W], [H, W, 1] or [H, W, 3], got {img.shape}")
    h, w, bpp = img.shape
    x = np.zeros((h + 1, w + 1, bpp), np.int16)
    x[1:, 1:] = img
    a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    filtered = ((x[1:, 1:] - _paeth(a, b, c)) & 255).astype(np.uint8).reshape(h, w * bpp)
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
