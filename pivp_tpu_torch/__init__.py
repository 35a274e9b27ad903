"""PyTorch/CUDA port of pivp_tpu, the action-conditioned ConvLSTM video
predictor. It imports torch and numpy, never JAX, and nothing of the JAX
package. Module names mirror pivp_tpu's so each counterpart is easy to
find; public functions keep the JAX layout (NHWC frames, time-major
stacks)."""
