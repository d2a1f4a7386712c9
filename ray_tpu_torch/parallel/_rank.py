"""A rank process of ``mesh.World``: joins the gloo world and runs the
functions the parent sends until told to stop."""

from ray_tpu_torch.parallel.mesh import _rank_main

if __name__ == "__main__":
    _rank_main()
