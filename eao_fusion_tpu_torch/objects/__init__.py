"""EAO object subsystem (port of `eao_fusion_tpu/objects/`): 2D frame
objects, 3D object landmarks, ensemble data association, isolation-forest
culling, merge/overlap resolution."""
