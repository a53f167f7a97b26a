"""Image output/input: PNG/PPM/PGM/TGA/HDR (+TIFF/JPEG via PIL), sRGB
(port of io/image.py, a numpy copy).

The reference displays through GL (optionally GL_FRAMEBUFFER_SRGB,
viewer.cpp:556-566) and loads png/jpeg/tga/tiff/pnm/hdr through its image
facade (src/common/*image*); headless rendering writes files instead.
``save_image``/``load_image`` dispatch on the extension; TGA / PNM /
Radiance-HDR codecs are self-contained numpy (no PIL needed).
Framebuffers are linear (H, W, 4) float32 with row 0 at the BOTTOM (GL
convention); files are written top-down.  Writers take numpy arrays or
tensors (copied to the host); readers return numpy arrays.

Without Pillow, ``save_png`` writes a binary PPM beside the requested
path (``name.ppm`` for ``name.png``) and returns that path, as the JAX
package's does: callers read the path it returns.
"""

from __future__ import annotations

import os

import numpy as np

from visionaray_torch.device import to_numpy



def linear_to_srgb(x):
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def to_uint8(img, srgb: bool = True):
    """(H, W, C) linear float -> top-down uint8 image."""
    img = to_numpy(img)
    if srgb:
        img = linear_to_srgb(img)
    else:
        img = np.clip(img, 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # bottom-up framebuffer -> top-down file


def save_png(path: str, img, srgb: bool = True):
    """PNG through Pillow; without Pillow a PPM (returns the path
    written)."""
    arr = to_uint8(img, srgb)
    try:
        from PIL import Image
    except ImportError:
        return save_ppm(str(path).rsplit(".", 1)[0] + ".ppm", img, srgb)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[-1] if arr.ndim == 3 else 1]
    Image.fromarray(arr.squeeze() if mode == "L" else arr, mode).save(path)
    return path


def save_ppm(path: str, img, srgb: bool = True):
    arr = to_uint8(img, srgb)
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        arr = arr[..., :3]
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
    return path


def save_pgm(path: str, img, srgb: bool = True):
    """Grayscale PNM (P5); color input is converted via Rec.709 luma."""
    arr = to_uint8(img, srgb)
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        arr = (0.2126 * arr[..., 0] + 0.7152 * arr[..., 1]
               + 0.0722 * arr[..., 2] + 0.5).astype(np.uint8)
    arr = arr.squeeze()
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
    return path


def load_pnm(path: str, srgb: bool = True):
    """P5/P6 binary PNM -> linear float (H, W, 4), bottom-up."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval separated by whitespace/comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while data[j:j + 1] not in b" \t\r\n":
            j += 1
        if j > i:
            tokens.append(data[i:j])
        i = j + 1
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), \
        int(tokens[3])
    ch = 3 if magic == b"P6" else 1
    raw = np.frombuffer(data, np.uint8, count=w * h * ch, offset=i)
    arr = raw.reshape(h, w, ch).astype(np.float32) / maxval
    if ch == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if srgb:
        arr = srgb_to_linear(arr)
    arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    return arr[::-1]


def save_tga(path: str, img, srgb: bool = True):
    """Uncompressed true-color TGA (type 2, 24-bit BGR, top-left origin)."""
    arr = to_uint8(img, srgb)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    arr = arr[..., :3][..., ::-1]  # RGB -> BGR
    h, w = arr.shape[:2]
    hdr = np.zeros(18, np.uint8)
    hdr[2] = 2                      # uncompressed true-color
    hdr[12:14] = (w & 255, w >> 8)
    hdr[14:16] = (h & 255, h >> 8)
    hdr[16] = 24
    hdr[17] = 0x20                  # top-left origin
    with open(path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(np.ascontiguousarray(arr).tobytes())
    return path


def load_tga(path: str, srgb: bool = True):
    """Uncompressed type-2 TGA -> linear float (H, W, 4), bottom-up."""
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(18), np.uint8)
        idlen = int(hdr[0])
        if hdr[2] != 2:
            raise ValueError("only uncompressed true-color TGA supported")
        w = int(hdr[12]) | (int(hdr[13]) << 8)
        h = int(hdr[14]) | (int(hdr[15]) << 8)
        bpp = int(hdr[16]) // 8
        f.read(idlen)
        raw = np.frombuffer(f.read(w * h * bpp), np.uint8)
    arr = raw.reshape(h, w, bpp).astype(np.float32) / 255.0
    rgb = arr[..., :3][..., ::-1]   # BGR -> RGB
    a = arr[..., 3:4] if bpp == 4 else np.ones_like(rgb[..., :1])
    if srgb:
        rgb = srgb_to_linear(rgb)
    out = np.concatenate([rgb, a], axis=-1)
    if not (hdr[17] & 0x20):        # bottom-left origin file
        return out
    return out[::-1]                # top-left file -> bottom-up buffer


def save_hdr(path: str, img):
    """Radiance RGBE (.hdr): shared-exponent HDR, no clipping, linear.

    The write path the reference lacks (it only LOADS hdr); flat
    (non-RLE) scanlines, which every reader accepts.
    """
    img = to_numpy(img).astype(np.float32)[::-1]    # top-down file
    rgb = np.maximum(img[..., :3], 0.0)
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    nz = maxc >= 1e-32
    _, e = np.frexp(np.where(nz, maxc, 1.0))
    scale = np.where(nz, np.ldexp(256.0, -e), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def load_hdr(path: str):
    """Radiance RGBE (.hdr) -> linear float (H, W, 4), bottom-up.

    Handles flat and adaptive-RLE scanlines (the format the reference's
    loader reads).
    """
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; next line is the resolution
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)
    rgbe = np.zeros((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        if w >= 8 and w < 32768 and buf[i] == 2 and buf[i + 1] == 2 \
                and (int(buf[i + 2]) << 8 | int(buf[i + 3])) == w:
            i += 4                          # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    cnt = int(buf[i])
                    i += 1
                    if cnt > 128:           # run
                        rgbe[y, x:x + cnt - 128, c] = buf[i]
                        x += cnt - 128
                        i += 1
                    else:                   # literal
                        rgbe[y, x:x + cnt, c] = buf[i:i + cnt]
                        x += cnt
                        i += cnt
        else:                               # flat scanline
            rgbe[y] = buf[i:i + 4 * w].reshape(w, 4)
            i += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    return out[::-1]


def save_image(path: str, img, srgb: bool = True):
    """Save by extension: png/jpg/tif (PIL), ppm/pgm/tga/hdr (built-in).

    The counterpart of the reference's 6-format image facade
    (src/common/image.cpp); .hdr output is linear (srgb ignored).
    """
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".ppm":
        return save_ppm(path, img, srgb)
    if ext in (".pgm", ".pnm"):
        return save_pgm(path, img, srgb)
    if ext == ".tga":
        return save_tga(path, img, srgb)
    if ext == ".hdr":
        return save_hdr(path, img)
    return save_png(path, img, srgb)


def load_image(path: str, srgb: bool = True):
    """Load an image file to linear float (H, W, 4), bottom-up."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".ppm", ".pgm", ".pnm"):
        return load_pnm(path, srgb)
    if ext == ".tga":
        return load_tga(path, srgb)
    if ext == ".hdr":
        return load_hdr(path)
    from PIL import Image
    arr = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
    if srgb:
        arr = srgb_to_linear(arr)
    return arr[::-1]
