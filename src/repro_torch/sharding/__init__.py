"""Logical-axis sharding rules over ``torch.distributed`` device meshes."""
