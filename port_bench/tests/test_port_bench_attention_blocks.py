"""The reference's attention in blocks of rows gives what one block gives:
the same dropout mask (drawn whole from the same generator state) and the
same context, to float32 rounding."""

from __future__ import annotations

import torch

from port_bench.reference import bert


def test_attention_blocks_match_one_block(monkeypatch):
    cfg = bert.BertConfig(hidden_size=32, num_attention_heads=4)
    torch.manual_seed(0)
    core = bert.BertAttentionCore(cfg)
    x = torch.randn(7, 5, 32)
    mask = torch.ones(7, 5)
    mask[2, 3:] = 0
    bias = bert.extended_attention_mask(mask)

    def run(block):
        monkeypatch.setattr(bert, "ATTN_BLOCK", block)
        gen = torch.Generator().manual_seed(11)
        out = core(x, x, bias, gen)
        return out, torch.rand(3, generator=gen)

    whole, after_whole = run(1 << 28)
    blocks, after_blocks = run(4 * 5 * 5 * 2)
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    # the generator advanced alike: later draws match too
    assert torch.equal(after_whole, after_blocks)
    # and the dropout did act: no generator gives another result
    plain = core(x, x, bias, None)
    assert not torch.allclose(plain, whole)
