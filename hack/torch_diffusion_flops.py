"""Operations of the port's diffusion pipeline at the presets' full widths,
counted by ``torch.utils.flop_counter`` over the port's own functions on
the ``meta`` device (no memory, no card): a UNet call at the guided
batches of 2 and 8, the VAE decode of one image and the text encode of one
guided prompt pair. The bound of a call is its count over the H100's
989 TFLOP/s of dense bf16.

Run: ``python3 hack/torch_diffusion_flops.py`` (CPU, a few seconds).
"""

import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpustack_tpu_torch.models import diffusion as dm  # noqa: E402

PEAK_BF16_FLOPS = 989e12


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main() -> None:
    meta = torch.device("meta")
    # the init resolves its device to the card or the CPU; here every
    # tensor lives on the meta device instead
    dm.resolve_device = lambda device: meta
    for name in ("sd15-shaped", "sdxl-shaped"):
        cfg = dm.DIFFUSION_PRESETS[name]
        params = dm.init_diffusion_params(cfg, torch.Generator(), meta)
        s = cfg.latent_size
        for batch in (2, 8):
            added = None
            if cfg.addition_embed:
                added = {
                    "pooled_text": torch.empty(
                        batch, cfg.text2_projection_dim, device=meta),
                    "time_ids": torch.empty(batch, 6, device=meta),
                }
            flops = _flops(lambda: dm.unet_apply(
                params, cfg, torch.empty(batch, cfg.latent_channels, s, s,
                                         device=meta),
                torch.zeros(batch, dtype=torch.int32, device=meta),
                torch.empty(batch, cfg.max_text_len, cfg.context_dim,
                            dtype=torch.bfloat16, device=meta),
                added))
            print(f"{name} unet batch {batch}: {flops / 1e12:.4f} TFLOP, "
                  f"bound {flops / PEAK_BF16_FLOPS * 1e3:.2f} ms")
        flops = _flops(lambda: dm.vae_decode(
            params, cfg, torch.empty(1, cfg.latent_channels, s, s,
                                     device=meta)))
        print(f"{name} vae: {flops / 1e12:.4f} TFLOP, "
              f"bound {flops / PEAK_BF16_FLOPS * 1e3:.2f} ms")
        toks = torch.zeros(1, cfg.max_text_len, dtype=torch.long, device=meta)
        flops = _flops(lambda: dm.encode_prompts(
            params, cfg, toks, toks, cfg.image_size, cfg.image_size))
        print(f"{name} text encode: {flops / 1e12:.4f} TFLOP")


if __name__ == "__main__":
    main()
