"""Multi-rank programs of the port: the mesh over ``torch.distributed``
(``mesh``) and the sequence-parallel x tensor-parallel denoise
(``sp_denoise``). Importing the package starts nothing: process groups are
made by the caller, meshes by ``mesh.make_mesh``."""
