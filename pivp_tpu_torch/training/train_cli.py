"""Training CLI of the PyTorch port: the reference entry point's 19 flags
(names, types, defaults) as the JAX package's `train_cli` has them, that
CLI's extras (--seed, --compute_dtype, --lstm_gate_compute, --remat,
--fused_cdna, --merge_output_convs, --u8_transfer, --grad_accum,
--steps_per_call, --prefetch, --lazy_load, --synthetic, --profile_dir,
--checkpointer {npz,torch} in place of {npz,orbax}, --run_name,
--graceful_preemption, --reference_literal), the kernel switches
--use_kernel / --use_kernel_gates in place of --use_pallas,
--image_height / --image_width, --device (default cuda), and the
data-parallel flags --num_devices, --spatial_parallel (1 only) and
--coordinator_address / --num_processes / --process_id, on a
torch.distributed process group (parallel/multihost.py). Left out are
the v5e lowering flags (--scan_unroll, --pad_gate_convs, --use_pallas).

Data parallelism runs one process per GPU. Two processes on one host:

  python -m pivp_tpu_torch.training.train_cli --coordinator_address \
      127.0.0.1:29500 --num_processes 2 --process_id 0 ... &
  python -m pivp_tpu_torch.training.train_cli --coordinator_address \
      127.0.0.1:29500 --num_processes 2 --process_id 1 ...

(NCCL on GPUs, a GPU for each rank; gloo on the CPU).
--batch_size is the global batch, which the ranks share equally.

Usage: python -m pivp_tpu_torch.training.train_cli [OPTIONS]
"""

from __future__ import annotations

import logging

import click

from pivp_tpu_torch.config import TrainConfig
from pivp_tpu_torch.utils import logging_utils


@click.command()
@click.option('--data_dir', type=click.Path(),
              default='data/processed/brain-robotics-data/push/push_train',
              help='Directory containing data.')
@click.option('--output_dir', type=click.Path(), default='models',
              help='Directory for model checkpoints.')
@click.option('--event_log_dir', type=click.Path(), default='models',
              help='Directory for writing summary.')
@click.option('--num_iterations', type=click.INT, default=100000,
              help='Number of training iterations.')
@click.option('--pretrained_model', type=click.Path(), default='',
              help='Filepath of a pretrained model to initialize from.')
@click.option('--pretrained_state', type=click.Path(), default='',
              help='Filepath of a pretrained optimizer state to '
                   'initialize from.')
@click.option('--sequence_length', type=click.INT, default=10,
              help='Sequence length, including context frames.')
@click.option('--context_frames', type=click.INT, default=2,
              help='Number of frames before predictions.')
@click.option('--use_state', type=click.INT, default=1,
              help='Whether or not to give the state+action to the model.')
@click.option('--model_type', type=click.STRING, default='CDNA',
              help='Model architecture to use - CDNA, DNA, or STP.')
@click.option('--num_masks', type=click.INT, default=10,
              help='Number of masks, usually 1 for DNA, 10 for CDNA, STP.')
@click.option('--schedsamp_k', type=click.FLOAT, default=900.0,
              help='The k parameter for scheduled sampling. -1 for none.')
@click.option('--train_val_split', type=click.FLOAT, default=0.95,
              help='The percentage of data to use for the training set.')
@click.option('--batch_size', type=click.INT, default=32,
              help='Batch size for training.')
@click.option('--learning_rate', type=click.FLOAT, default=0.001,
              help='The base learning rate of the generator.')
@click.option('--gpu', type=click.INT, default=-1,
              help='Accepted for reference CLI compatibility; the device '
                   'is chosen with --device.')
@click.option('--validation_interval', type=click.INT, default=200,
              help='How often (epochs) to run the validation sweep.')
@click.option('--save_interval', type=click.INT, default=50,
              help='How often (epochs) to save a model checkpoint.')
@click.option('--debug', type=click.INT, default=0, help='Debug mode.')
@click.option('--seed', type=click.INT, default=0, help='PRNG seed.')
@click.option('--image_height', type=click.INT, default=64,
              help='Frame height.')
@click.option('--image_width', type=click.INT, default=64,
              help='Frame width.')
@click.option('--compute_dtype', type=click.STRING, default='auto',
              help='auto (float32), float32, or bfloat16.')
@click.option('--lstm_gate_compute', type=click.STRING, default='auto',
              help='ConvLSTM gate precision of the plain gate math: auto '
                   '(float32), compute, or float32.')
@click.option('--remat', type=click.INT, default=0,
              help='Recompute each timestep in the backward (memory for '
                   'FLOPs).')
@click.option('--use_kernel', type=click.INT, default=1,
              help='Hand-written CUDA local-apply kernels in the fused '
                   'CDNA composite (1 on, 0 plain ops).')
@click.option('--use_kernel_gates', type=click.INT, default=1,
              help='Hand-written CUDA ConvLSTM gate kernels (1 on, 0 '
                   'plain ops).')
@click.option('--fused_cdna', type=click.INT, default=1,
              help='Fuse the CDNA transform + mask composite into one '
                   'per-pixel kernel (algebraically exact).')
@click.option('--merge_output_convs', type=click.INT, default=1,
              help='Evaluate the masks deconv and the head enc7 deconv '
                   'as ONE conv over concatenated output channels '
                   '(algebraically exact).')
@click.option('--u8_transfer', type=click.INT, default=1,
              help='Ship frames to the device as uint8, dequantize '
                   'on the device (4x less host->device traffic).')
@click.option('--grad_accum', type=click.INT, default=1,
              help='Gradient-accumulation microbatches per step (exact '
                   'for the mean loss).')
@click.option('--steps_per_call', type=click.INT, default=0,
              help='Optimizer steps per dispatch. 0 = auto (1); K > 1 '
                   'runs K steps a dispatch, on the GPU as replays of a '
                   'CUDA graph of the train step.')
@click.option('--prefetch', type=click.INT, default=2,
              help='Input-pipeline prefetch depth (0 = assemble batches '
                   'on the main thread).')
@click.option('--lazy_load', type=click.INT, default=0,
              help='Read sequences from disk per batch instead of '
                   'loading the whole dataset into RAM.')
@click.option('--synthetic', type=click.INT, default=0,
              help='Train on N synthetic sequences instead of data_dir.')
@click.option('--profile_dir', type=click.Path(), default='',
              help='If set, write a torch.profiler trace of the WHOLE '
                   'run there (keep num_iterations small).')
@click.option('--checkpointer', type=click.Choice(['npz', 'torch']),
              default='npz',
              help='npz = reference artifact contract; torch adds an '
                   'atomic full-state checkpoint and auto-resume.')
@click.option('--run_name', type=click.STRING, default='',
              help='Run directory name (default: timestamped). Reuse a '
                   'name with --checkpointer torch to resume that run.')
@click.option('--graceful_preemption', type=click.INT, default=1,
              help='Catch SIGTERM/SIGINT, checkpoint at the next dispatch '
                   'boundary and exit cleanly; with --checkpointer torch '
                   'the next launch resumes from the exact optimizer '
                   'step.')
@click.option('--reference_literal', type=click.INT, default=0,
              help='Train with the reference Chainer implementation\'s '
                   'LITERAL semantics (detached scheduled sampling, '
                   'mask-softmax scramble). 0 (default) = original-TF-'
                   'intent semantics.')
@click.option('--num_devices', type=click.INT, default=0,
              help='Data-parallel devices (0 = all). One process drives '
                   'one GPU, so this is the process group\'s ranks: 0 = '
                   'every rank; N > 0 must equal --num_processes, else '
                   'it raises.')
@click.option('--spatial_parallel', type=click.INT, default=1,
              help='Spatial (image-height) model-parallel ways on top of '
                   'data parallelism. Not ported yet: 1 = off, and any '
                   'value above 1 raises (ROADMAP.md, item 7).')
@click.option('--coordinator_address', type=click.STRING, default='',
              help='Multi-process mode: host:port of process 0 (the '
                   'torch.distributed TCP rendezvous). Launch one '
                   'identical process per GPU, each with --num_processes '
                   'and its own --process_id; batches are assembled from '
                   'per-rank shards; npz artifacts and full-state.pt are '
                   'written by process 0 (shared filesystem). Empty '
                   '(default) = single-process, or the WORLD_SIZE/RANK '
                   'environment that torchrun sets.')
@click.option('--num_processes', type=click.INT, default=0,
              help='Multi-process: total process count (with '
                   '--coordinator_address).')
@click.option('--process_id', type=click.INT, default=-1,
              help='Multi-process: this process\'s id in [0, '
                   'num_processes).')
@click.option('--device', type=click.Choice(['cuda', 'cpu']),
              default='cuda', help='Torch device to run on.')
def main(data_dir, output_dir, event_log_dir, num_iterations,
         pretrained_model, pretrained_state, sequence_length,
         context_frames, use_state, model_type, num_masks, schedsamp_k,
         train_val_split, batch_size, learning_rate, gpu,
         validation_interval, save_interval, debug, seed, image_height,
         image_width, compute_dtype, lstm_gate_compute, remat, use_kernel,
         use_kernel_gates, fused_cdna, merge_output_convs, u8_transfer,
         grad_accum, steps_per_call, prefetch, lazy_load, synthetic,
         profile_dir, checkpointer, run_name, graceful_preemption,
         reference_literal, num_devices, spatial_parallel,
         coordinator_address, num_processes, process_id, device):
    """Train the video prediction model on processed robot-push data."""
    logging_utils.setup_logging(
        logging.DEBUG if debug else logging.INFO)
    logger = logging.getLogger(__name__)

    import torch.distributed as dist

    from pivp_tpu_torch.parallel import multihost

    # Join the process group before anything touches the device; a
    # group that this call creates is left again at its end.
    had_group = dist.is_initialized()
    if coordinator_address:
        multihost.initialize(coordinator_address, num_processes,
                             process_id, device=device)
    else:
        multihost.initialize(device=device)   # WORLD_SIZE/RANK, if set
    if dist.is_initialized():
        logger.info('Multi-process: process %d/%d',
                    *multihost.process_info())
    try:
        cfg = TrainConfig(
            data_dir=data_dir, output_dir=output_dir,
            event_log_dir=event_log_dir, num_iterations=num_iterations,
            pretrained_model=pretrained_model,
            pretrained_state=pretrained_state,
            sequence_length=sequence_length, context_frames=context_frames,
            use_state=bool(use_state), model_type=model_type,
            num_masks=num_masks, schedsamp_k=schedsamp_k,
            train_val_split=train_val_split, batch_size=batch_size,
            learning_rate=learning_rate,
            validation_interval=validation_interval,
            save_interval=save_interval, debug=bool(debug), seed=seed,
            image_height=image_height, image_width=image_width,
            compute_dtype=compute_dtype, lstm_gate_compute=lstm_gate_compute,
            remat=bool(remat), use_kernel=bool(use_kernel),
            use_kernel_gates=bool(use_kernel_gates),
            fused_cdna=bool(fused_cdna),
            merge_output_convs=bool(merge_output_convs),
            u8_transfer=bool(u8_transfer), grad_accum=grad_accum,
            reference_literal=bool(reference_literal), device=device,
            steps_per_call=steps_per_call, prefetch=prefetch,
            lazy_load=bool(lazy_load), checkpointer=checkpointer,
            graceful_preemption=bool(graceful_preemption),
            num_devices=num_devices, spatial_parallel=spatial_parallel,
        )

        mcfg = cfg.model_config()
        logger.info('Training the model')
        logger.info('Model: %s', model_type)
        logger.info('# Minibatch-size: %s', batch_size)
        logger.info('# Num iterations: %s', num_iterations)
        logger.info('Device: %s  compute dtype: %s  kernels: %s/%s  '
                    'fused_cdna: %s  u8_transfer: %s', device,
                    mcfg.compute_dtype, mcfg.use_kernel, mcfg.use_kernel_gates,
                    mcfg.fused_cdna, cfg.u8_transfer)

        arrays = None
        if synthetic:
            from pivp_tpu_torch.data import synthetic as synth
            arrays = synth.generate_sequences(
                synthetic, sequence_length, image_height, image_width,
                seed=seed)
            logger.info('Using %d synthetic sequences', synthetic)

        from pivp_tpu_torch.training import loop
        from pivp_tpu_torch.utils import profiling

        with profiling.trace(profile_dir):
            result = loop.run_training(cfg, arrays=arrays,
                                       run_name=run_name or None)
        logger.info('Done; checkpoints in %s', result["save_dir"])
        return result
    finally:
        if not had_group:
            multihost.shutdown()


if __name__ == '__main__':
    main()
