from blt_vqg_tpu_torch.parallel.mesh import LocalRing, Mesh, build_mesh

__all__ = ["LocalRing", "Mesh", "build_mesh"]
