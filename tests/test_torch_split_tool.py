"""split_fwd_kernels.py's switches find their text in today's headers.

The tool times the kernels with parts switched off by editing a copy of
csrc/; a header rewrite that moves a pattern breaks it only on the card.
Here each mode's `masked_sources` runs on the CPU (no build): every switch
must match exactly once, and the masked copy must carry the mask."""

import pytest

from mipnerf_pl_tpu_torch import split_fwd_kernels as split


@pytest.mark.parametrize('argv,edited,mask', [
    ([], ('lean_engines.cuh',), 'FWD_OFF'),
    (['--f32'], ('lean_engines.cuh',), 'FWD_OFF'),
    (['--sm90'], ('lean_fwd_sm90.cuh', 'lean_engines.cuh'), 'FWD_OFF'),
    (['--tf32'], ('lean_fwd_tf32.cuh', 'lean_engines.cuh'), 'FWD_OFF'),
    (['--tune'], ('lean_fwd_sm90.cuh',), 'FW_STAGES_N'),
    (['--chain'], ('lean_fwd_tf32.cuh', 'lean_chain_tf32.cuh'), 'FWD_OFF'),
    (['--wgrad'], ('lean_wgrad_tf32.cuh',), 'WT_OFF')],
    ids=['default', 'f32', 'sm90', 'tf32', 'tune', 'chain', 'wgrad'])
def test_masked_sources_find_every_switch(tmp_path, argv, edited, mask):
    split.configure(argv)
    try:
        dst = split.masked_sources(str(tmp_path))
        for name in edited:
            text = (tmp_path / 'csrc' / name).read_text()
            assert text != (split._build.SRC_DIR / name).read_text(), name
            assert mask in text, name
        assert dst == str(tmp_path / 'csrc')
        assert split.variants()
    finally:
        split.configure([])


def test_chain_switches_reach_both_epilogues(tmp_path):
    """--chain's bit 4 now reaches the two NC / 8 epilogue loops of
    lean_chain_tf32.cuh (a layer's step and an input-cotangent step)."""
    split.configure(['--chain'])
    try:
        split.masked_sources(str(tmp_path))
    finally:
        split.configure([])
    text = (tmp_path / 'csrc' / 'lean_chain_tf32.cuh').read_text()
    assert text.count('((FWD_OFF & 4) ? 0 : NC / 8)') == 2
    assert 'for (int j = 0; j < NC / 8; ++j)' not in text
