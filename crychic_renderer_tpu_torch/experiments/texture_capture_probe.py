"""Whether CUDA makes a texture object inside a stream capture in CUDA's
global capture mode, PyTorch's default for ``torch.cuda.graph``.

    python -m crychic_renderer_tpu_torch.experiments.texture_capture_probe

Begins a capture on a side stream, calls the soft PCF library's
``crychic_soft_pcf_texture`` (``cudaCreateTextureObject`` over the
window-ready buffer of a 64^2 16-bit map) and one kernel inside it, and
ends the capture. Prints one
JSON line: the card, the C entry's return code and CUDA's message for
it, whether it made an object, and "ok" or the error that ended the
capture. The compiled frame does not depend on the answer: it makes its
texture objects before the capture (``ops/pcf.OwnedMaps``). Run it in a
process of its own: a refused call leaves the capture's stream state
behind. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..ops import pcf


def main():
    if not torch.cuda.is_available():
        raise SystemExit("texture_capture_probe: needs a CUDA device")
    lib = pcf.LIBRARY.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    buf = pcf.quantize_map(torch.zeros((1, 64, 64), device="cuda"))
    torch.cuda.synchronize()
    tex, has_tex = ctypes.c_ulonglong(0), ctypes.c_int(0)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    rc, capture = None, "ok"
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="global")
            try:
                rc = lib.crychic_soft_pcf_texture(
                    buf.data_ptr(), 1, 64, pcf.window_pitch(64),
                    ctypes.byref(tex), ctypes.byref(has_tex))
                buf.add_(1)
            finally:
                graph.capture_end()
    except RuntimeError as e:
        capture = str(e).strip().splitlines()[0]
    if rc == 0 and has_tex.value:
        lib.crychic_soft_pcf_texture_destroy(tex.value)
    print(json.dumps(dict(
        card=smi, capture_mode="global", create_rc=rc,
        create_error=(None if rc is None
                      else lib.crychic_soft_pcf_error(rc).decode()),
        made_object=bool(has_tex.value), capture=capture)), flush=True)


if __name__ == "__main__":
    main()
