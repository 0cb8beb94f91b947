"""Elastic restore (port of ``repro.runtime.elastic``'s
``elastic_restore``): the latest checkpoint restored onto the devices of a
template state.  The data pipeline is stateless in (step, shard), so a
resumed job needs nothing else.  The mesh half (``make_current_mesh``) is
ROADMAP item 27: the port trains on one device.
"""
from __future__ import annotations

from repro_torch.checkpoint.checkpoint import latest_step, restore_checkpoint


def elastic_restore(ckpt_dir: str, template_state):
    """Restore the latest checkpoint in ``ckpt_dir`` into the structure,
    shapes, dtypes and devices of ``template_state`` (a tree of tensors).
    Returns (state, step), or (template_state, None) when there is no
    checkpoint."""
    step = latest_step(ckpt_dir)
    if step is None:
        return template_state, None
    return restore_checkpoint(ckpt_dir, step, template_state), step
