"""Prediction CLI of the PyTorch port: the options of
`pivp_tpu/inference/predict_cli.py`, plus `--device` (default cuda).

Usage: python -m pivp_tpu_torch.inference.predict_cli MODEL_DIR MODEL_NAME
       DATA_INDEX [--device cuda|cpu]
"""

from __future__ import annotations

import logging

import click

from pivp_tpu_torch.inference import predict as predict_lib


@click.command()
@click.argument('model_dir', type=click.STRING)
@click.argument('model_name', type=click.STRING)
@click.argument('data_index', type=click.INT)
@click.option('--models_dir', type=click.Path(exists=True),
              default='models', help='Directory containing the models.')
@click.option('--data_dir', type=click.Path(exists=True),
              default='data/processed/brain-robotics-data/push/'
                      'push_testnovel',
              help='Directory containing data.')
@click.option('--time_step', type=click.INT, default=8,
              help='Number of time steps to predict.')
@click.option('--model_type', type=click.STRING, default='',
              help='Type of the trained model.')
@click.option('--schedsamp_k', type=click.FLOAT, default=-1,
              help='The k parameter for scheduled sampling. -1 for none.')
@click.option('--context_frames', type=click.INT, default=2,
              help='Number of frames before predictions.')
@click.option('--use_state', type=click.INT, default=1,
              help='Whether or not to give the state+action to the model.')
@click.option('--num_masks', type=click.INT, default=10,
              help='Number of masks, usually 1 for DNA, 10 for CDNA, STP.')
@click.option('--image_height', type=click.INT, default=64,
              help='Height of one predicted frame.')
@click.option('--image_width', type=click.INT, default=64,
              help='Width of one predicted frame.')
@click.option('--original_image_height', type=click.INT, default=512,
              help='Height of one original frame.')
@click.option('--original_image_width', type=click.INT, default=640,
              help='Width of one original frame.')
@click.option('--downscale_factor', type=click.FLOAT, default=0.5,
              help='Downscale the rendered frames by this factor.')
@click.option('--gpu', type=click.INT, default=-1,
              help='Accepted for reference CLI compatibility.')
@click.option('--gif', type=click.INT, default=1,
              help='Create a GIF of the predicted result.')
@click.option('--renormalize', type=click.INT, default=0,
              help='Reference-compat per-frame min/max rescaling instead '
                   'of clipping.')
@click.option('--reference_literal', type=click.INT, default=0,
              help='Run the forward with the reference Chainer '
                   'implementation\'s LITERAL semantics (mask-softmax '
                   'scramble, DNA border zeroing, ...). Use when the '
                   'checkpoint was imported from the reference '
                   '(pivp-convert) so its predictions are reproduced '
                   'exactly.')
@click.option('--device', type=click.STRING, default='cuda',
              help='Torch device to run on: cuda (default) or cpu.')
def main(model_dir, model_name, data_index, models_dir, data_dir,
         time_step, model_type, schedsamp_k, context_frames, use_state,
         num_masks, image_height, image_width, original_image_height,
         original_image_width, downscale_factor, gpu, gif, renormalize,
         reference_literal, device):
    """Predict the next TIME_STEP frames from a trained
    MODEL_DIR/MODEL_NAME."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    out = predict_lib.predict_and_render(
        model_dir, model_name, data_index, models_dir=models_dir,
        data_dir=data_dir, time_step=time_step, model_type=model_type,
        schedsamp_k=schedsamp_k, context_frames=context_frames,
        use_state=bool(use_state), num_masks=num_masks,
        image_height=image_height, image_width=image_width,
        original_image_height=original_image_height,
        original_image_width=original_image_width,
        downscale_factor=downscale_factor, gif=bool(gif),
        renormalize=bool(renormalize),
        reference_literal=bool(reference_literal), device=device)
    logging.getLogger(__name__).info("Wrote %s", out)


if __name__ == '__main__':
    main()
