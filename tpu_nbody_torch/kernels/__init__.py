"""Build and loading of the hand-written CUDA kernels (see ``_build``)."""
