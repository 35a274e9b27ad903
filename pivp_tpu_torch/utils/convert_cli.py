"""Checkpoint migration CLI of the PyTorch port: the Chainer reference's
npz layout <-> the port's checkpoint npz.

The port's counterpart of `pivp_tpu/utils/convert_cli.py`, with the same
commands and options: `import` brings a Chainer
`serializers.save_npz(Model)` checkpoint in as a checkpoint that
`load_model` and `load_npz_into` read (which the JAX package reads too);
`export` writes one back in the Chainer layout. The layout map is
`utils/checkpoint.py`'s `convert_reference_npz` /
`export_reference_npz`. Both run on the CPU.

Usage:
  python -m pivp_tpu_torch.utils.convert_cli import chainer.npz ours.npz \\
      --model_type CDNA --num_masks 10
  python -m pivp_tpu_torch.utils.convert_cli export ours.npz chainer.npz \\
      --model_type CDNA --num_masks 10
"""

from __future__ import annotations

import logging

import click
import torch

from pivp_tpu_torch.utils import logging_utils

logger = logging.getLogger(__name__)


def _model_options(f):
    opts = [
        click.option('--model_type', type=click.STRING, default='CDNA',
                     help='CDNA, DNA, or STP.'),
        click.option('--num_masks', type=click.INT, default=10,
                     help='Number of masks, usually 1 for DNA, 10 for '
                          'CDNA, STP.'),
        click.option('--use_state', type=click.INT, default=1),
        click.option('--image_height', type=click.INT, default=64),
        click.option('--image_width', type=click.INT, default=64),
    ]
    for o in reversed(opts):
        f = o(f)
    return f


def _cfg_and_template(model_type, num_masks, use_state, image_height,
                      image_width):
    from pivp_tpu_torch.config import ModelConfig
    from pivp_tpu_torch.models import predictor

    cfg = ModelConfig(model_type=model_type, num_masks=num_masks,
                      use_state=bool(use_state), image_height=image_height,
                      image_width=image_width)
    return cfg, predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")


@click.group()
def main():
    """Convert checkpoints between the Chainer reference's npz layout and
    the port's."""
    logging_utils.setup_logging()


@main.command('import')
@click.argument('src', type=click.Path(exists=True))
@click.argument('dst', type=click.Path())
@_model_options
def import_(src, dst, model_type, num_masks, use_state, image_height,
            image_width):
    """Chainer-layout SRC npz -> the port's checkpoint DST npz."""
    from pivp_tpu_torch.utils import checkpoint as ckpt_lib

    cfg, template = _cfg_and_template(model_type, num_masks, use_state,
                                      image_height, image_width)
    params = ckpt_lib.convert_reference_npz(src, cfg, template)
    ckpt_lib.save_npz(dst, params)
    logger.info('Imported %s -> %s (the Chainer layout validated against '
                'the %s parameter tree)', src, dst, model_type)


@main.command('export')
@click.argument('src', type=click.Path(exists=True))
@click.argument('dst', type=click.Path())
@_model_options
def export_(src, dst, model_type, num_masks, use_state, image_height,
            image_width):
    """The port's checkpoint SRC npz -> Chainer-layout DST npz."""
    from pivp_tpu_torch.utils import checkpoint as ckpt_lib

    cfg, template = _cfg_and_template(model_type, num_masks, use_state,
                                      image_height, image_width)
    params = ckpt_lib.load_npz_into(src, template)
    ckpt_lib.export_reference_npz(dst, cfg, params)
    logger.info('Exported %s -> %s in the Chainer npz key layout', src,
                dst)


if __name__ == '__main__':
    main()
