"""Host syncs a block makes (layer: entry): `torch.cuda.set_sync_debug_mode
("warn")` over a pass of the traced blocks, over the blocks of the pass."""


def read(trace):
    return trace.syncs / trace.sync_blocks if trace.sync_blocks else None
