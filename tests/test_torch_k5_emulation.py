"""K5's device code (``fused_step_kernel<S, false, true>`` and
``fused_stages_kernel<S, false, true>``, the REGION arm of K1's and K6's
bodies) run on the CPU block by block through
tests/test_torch_kernel_emulation.py's CUDA shim (a thread per CUDA
thread, NaN-filled shared memory).

The same shards, states, boxes and check as tests/test_torch_k5_host.py
(a shard with an inner face and the global edge in each sharded dim, the
group's full boxes reaching into nonzero ghost pads, then a ragged box):
against ``plain_shard_step``, bit-equal (tti by rtol 1e-5 and atol 1e-6
for g++'s libm).  Then a deliberately broken copy that clips a scratch
sub-stage at the shard's interior grown by its write halo, as K6 does on
one domain, rather than at the global domain's: bit-equal in a one-shard
mesh, wrong past every inner shard face, which the check sees.
"""

import pytest

from test_torch_k5_host import PLAIN_TOL, group_boxes, k5_steps, shard_of
from test_torch_kernel_emulation import emulated_kernel


@pytest.mark.parametrize("arm", ["scratch-tti", "rewrite-awp",
                                 "misc-test_misc_2d", "4d-test_4d",
                                 "bf16-iso3dfd"])
def test_k5_device_code_matches_plain_when_emulated(arm, tmp_path):
    kern, off, boxes = shard_of(arm)
    fn = emulated_kernel(kern.spec, tmp_path,
                         entry=kern.spec.name + "_region")
    k5_steps(fn, kern, off, group_boxes(kern, boxes),
             tol=PLAIN_TOL.get(arm, (0.0, 0.0)))


def test_k5_emulation_fails_with_the_shard_relative_scratch_clip(tmp_path):
    def shard_clip(name, text):
        if name != "fused_step.cuh":
            return text
        old = ("    lo -= p.go[s];\n"
               "    hi = p.gn[s] + clip_hi_of<S, K>(s) - p.go[s];\n")
        assert text.count(old) == 1
        return text.replace(old, "    lo -= p.lo[s];\n"
                                 "    hi = p.sn[s] + clip_hi_of<S, K>(s) "
                                 "- p.lo[s];\n")
    kern, off, boxes = shard_of("scratch-tti")
    fn = emulated_kernel(kern.spec, tmp_path, entry=kern.spec.name
                         + "_region", edit=shard_clip)
    with pytest.raises(AssertionError):
        k5_steps(fn, kern, off, boxes[:1], tol=PLAIN_TOL["scratch-tti"])
