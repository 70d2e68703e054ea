"""Example programs of the port, the JAX package's ``examples/*.py`` with
the same flags plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
torch versions):

    python -m tpu_nbody_torch.examples.sphere3d_demo --out sphere.gif
    python -m tpu_nbody_torch.examples.collide_demo --out collide.gif
    python -m tpu_nbody_torch.examples.drift_benchmark --solver allpairs
    python -m tpu_nbody_torch.examples.interactive

Each module's ``main(argv=None)`` parses ``argv`` (default: the command
line) and returns what it measured or wrote.
"""
