"""Visualization CLI of the PyTorch port: the options of
`pivp_tpu/visualization/visualize_cli.py`, plus `--device` (default
cuda). Loss curves for a run directory, plus per-layer activation grids
when --model_name is given.

Usage: python -m pivp_tpu_torch.visualization.visualize_cli MODEL_DIR
       [--model_name training-final.npz] [--device cuda|cpu] [OPTIONS]
"""

from __future__ import annotations

import logging
import os

import click

from pivp_tpu_torch.utils import logging_utils


@click.command()
@click.argument('model_dir', type=click.STRING)
@click.option('--model_name', type=click.STRING, default='',
              help='Checkpoint file inside MODEL_DIR to visualize '
                   'activations for.')
@click.option('--models_dir', type=click.Path(exists=True),
              default='models', help='Directory containing the models.')
@click.option('--data_dir', type=click.Path(),
              default='data/processed/brain-robotics-data/push/'
                      'push_testseen',
              help='Directory containing data.')
@click.option('--data_index', type=click.INT, default=0,
              help='Which sequence to run for activations.')
@click.option('--model_type', type=click.STRING, default='',
              help='Type of the trained model (inferred from dir name '
                   'if empty).')
@click.option('--num_masks', type=click.INT, default=10)
@click.option('--context_frames', type=click.INT, default=2)
@click.option('--use_state', type=click.INT, default=1)
@click.option('--time_step', type=click.INT, default=3,
              help='Frames to run for the activation pass.')
@click.option('--all_timesteps', type=click.INT, default=0,
              help='Render activation grids for EVERY rollout step '
                   '(default: first/middle/last).')
@click.option('--out_dir', type=click.Path(), default='',
              help='Output dir (defaults to reports/figures/<model_dir>).')
@click.option('--reference_literal', type=click.INT, default=0,
              help='Run the forward with the reference implementation\'s '
                   'literal semantics (for checkpoints imported from the '
                   'reference with convert_cli).')
@click.option('--device', type=click.Choice(['cuda', 'cpu']),
              default='cuda', help='Torch device to run on.')
def main(model_dir, model_name, models_dir, data_dir, data_index,
         model_type, num_masks, context_frames, use_state, time_step,
         all_timesteps, out_dir, reference_literal, device):
    """Render loss curves (and activation maps with --model_name)."""
    logging_utils.setup_logging()
    logger = logging.getLogger(__name__)

    from pivp_tpu_torch.visualization import visualize as viz

    run_dir = os.path.join(models_dir, model_dir)
    out_dir = out_dir or os.path.join("reports", "figures", model_dir)
    written = viz.plot_loss_curves(run_dir, out_dir)
    for w in written:
        logger.info("Wrote %s", w)

    if model_name:
        from pivp_tpu_torch.inference import predict as predict_lib

        if not model_type:
            model_type = predict_lib.infer_model_type(model_dir)
        image, _, _, action, state = predict_lib.get_data_info(
            data_dir, data_index)
        action = action[:, 0] if action.ndim == 3 else action
        state = state[:, 0] if state.ndim == 3 else state
        t = min(time_step + context_frames, image.shape[0])
        more = viz.visualize_model(
            os.path.join(run_dir, model_name), model_type,
            image[:t], action[:t], state[:t], out_dir,
            num_masks=num_masks, context_frames=context_frames,
            use_state=bool(use_state),
            all_timesteps=bool(all_timesteps),
            reference_literal=bool(reference_literal), device=device)
        for w in more:
            logger.info("Wrote %s", w)
        written += more
    return written


if __name__ == '__main__':
    main()
