"""Export a trained checkpoint as a serving artifact.

The port's counterpart of `pivp_tpu/inference/export_cli.py`, with its
flags, less `--platform` and plus `--device` (default cuda): the
artifact is a `torch.export` program (`.pt2`) traced on that device,
which `inference/export.load_serving_artifact` loads.

Usage:
  python -m pivp_tpu_torch.inference.export_cli MODEL_DIR MODEL_NAME \\
      OUT.pt2 [--batch 32] [--device cuda|cpu] [--model_type CDNA ...]

MODEL_DIR/MODEL_NAME follow the predict CLI's conventions: the run
directory's name `<date>-<time>-<TYPE>-<batch>` gives the model type
unless --model_type is given.
"""

from __future__ import annotations

import logging
import os

import click

from pivp_tpu_torch.utils import logging_utils

logger = logging.getLogger(__name__)


@click.command()
@click.argument('model_dir', type=click.STRING)
@click.argument('model_name', type=click.STRING)
@click.argument('out_path', type=click.Path())
@click.option('--models_dir', type=click.Path(), default='models')
@click.option('--batch', type=click.INT, default=32,
              help='Serving batch size baked into the artifact.')
@click.option('--device', type=click.STRING, default='cuda',
              help='Device the artifact is traced on and runs on (cuda '
                   'or cpu).')
@click.option('--model_type', type=click.STRING, default='')
@click.option('--num_masks', type=click.INT, default=10)
@click.option('--context_frames', type=click.INT, default=2)
@click.option('--sequence_length', type=click.INT, default=10)
@click.option('--use_state', type=click.INT, default=1)
@click.option('--image_height', type=click.INT, default=64)
@click.option('--image_width', type=click.INT, default=64)
def main(model_dir, model_name, out_path, models_dir, batch, device,
         model_type, num_masks, context_frames, sequence_length,
         use_state, image_height, image_width):
    """Serialize MODEL_DIR/MODEL_NAME as a torch.export serving
    artifact."""
    logging_utils.setup_logging()

    from pivp_tpu_torch.inference import export as export_lib
    from pivp_tpu_torch.inference import predict as predict_lib

    mt = model_type or predict_lib.infer_model_type(
        os.path.join(models_dir, model_dir))
    cfg, params = predict_lib.load_model(
        os.path.join(models_dir, model_dir, model_name), mt, num_masks,
        context_frames, bool(use_state), image_height=image_height,
        image_width=image_width, sequence_length=sequence_length,
        device=device)
    export_lib.export_serving_artifact(params, cfg, batch, out_path)
    logger.info('Wrote %s', out_path)


if __name__ == '__main__':
    main()
