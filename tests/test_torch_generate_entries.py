"""The port's other generation entries (`memory_augmented_vlm_torch/models/vlm.py`:
`generate_speculative`, `score_continuation`, `sample_video_frames`,
`video_qa_embeds`) against the JAX package's on the tiny config of
tests/test_vlm.py, fp32, the same converted weights and numpy inputs (the
split from test_torch_generate.py keeps each file short).

- speculative decoding: tokens, count and iterations equal at spec_k 2
  and 4, on the flat LM (greedy repeats a token, so prompt lookup proposes
  it and the drafts accept) and on a lively one (every matrix times 5)
  whose corpus is its own greedy continuation, with an eos that cuts an
  accepted window;
- scoring: the total log-probability within 1e-5 relative and the greedy
  flag equal, for 1 and 5 continuation tokens, greedy and random;
- frame sampling equal for every clip length 1..400; the spliced
  embeddings of 12-, 33- and 70-frame clips within 1e-5, and of a 13-frame
  uint8 clip through the device preprocess.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from memory_augmented_vlm_tpu import constants as jconstants
from memory_augmented_vlm_tpu.models import qwen2 as jqwen2
from memory_augmented_vlm_tpu.models import vlm as jvlm
from memory_augmented_vlm_torch import constants, convert
from memory_augmented_vlm_torch.models import vlm as tvlm
from test_vlm import TINY

PCFG = convert.config_from_fields(TINY)
MAX_NEW = 13
TEXT_BEFORE = [11, 872, 198]
TEXT_AFTER = [3838, 374, 12482, 304, 419, 2766, 30]


@pytest.fixture(scope="module")
def models():
    jp = jax.tree.map(np.asarray, jvlm.init_params(TINY, jax.random.key(0)))
    lively = dict(jp, language_model=jax.tree.map(lambda a: a * 5 if a.ndim >= 2 else a,
                                                  jp["language_model"]))
    return {name: (p, convert.from_jax_params(p, PCFG, device="cpu"))
            for name, p in (("flat", jp), ("lively", lively))}


def _single(seed, s=29):
    return (0.5 * np.random.default_rng(seed).standard_normal((s, 32))).astype(np.float32)


def test_image_token_index_equals_jax():
    assert constants.IMAGE_TOKEN_INDEX == jconstants.IMAGE_TOKEN_INDEX


# --------------------------------------------------------- speculative

@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("case", ["repetitive", "own_continuation_eos"])
def test_generate_speculative_matches_jax(models, spec_k, case):
    emb = _single(3)
    if case == "repetitive":
        jp, tp = models["flat"]
        draft = [7, 8, 7, 8, 7, 8, 9]
        eos = (151645,)
    else:
        jp, tp = models["lively"]
        greedy = np.asarray(jvlm.generate(jp, TINY, jnp.asarray(emb),
                                          max_new_tokens=MAX_NEW).tokens)
        draft = [5, 6] + greedy.tolist()  # the lookup finds every bigram ahead of it
        eos = (int(greedy[6]),)
    want, want_info = jvlm.generate_speculative(jp, TINY, jnp.asarray(emb), draft_ids=draft,
                                                max_new_tokens=MAX_NEW, eos_token_ids=eos,
                                                spec_k=spec_k)
    got, got_info = tvlm.generate_speculative(tp, PCFG, torch.from_numpy(emb),
                                              draft_ids=draft, max_new_tokens=MAX_NEW,
                                              eos_token_ids=eos, spec_k=spec_k)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert int(got.num_tokens) == int(want.num_tokens)
    assert got_info == want_info
    plain = jvlm.generate(jp, TINY, jnp.asarray(emb), max_new_tokens=MAX_NEW,
                          eos_token_ids=eos)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(plain.tokens))
    assert got_info["iterations"] < int(got.num_tokens)  # drafts were accepted
    if case != "repetitive":
        assert int(got.num_tokens) == 7  # the eos at step 6


def test_generate_speculative_refuses_spec_k_1(models):
    with pytest.raises(ValueError):
        tvlm.generate_speculative(models["flat"][1], PCFG, torch.zeros(5, 32), spec_k=1)


# ------------------------------------------------------------- scoring

@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("cont", ["greedy", "random"])
def test_score_continuation_matches_jax(models, t, cont):
    jp, tp = models["lively"]
    prefix = _single(4, s=21)
    if cont == "greedy":
        ids = np.asarray(jvlm.generate(jp, TINY, jnp.asarray(prefix), max_new_tokens=t,
                                       eos_token_ids=()).tokens)
    else:
        ids = np.random.default_rng(5).integers(0, TINY.lm.vocab_size, size=t).astype(np.int32)
    tail = np.asarray(jqwen2.embed_tokens(jp["language_model"], jnp.asarray(ids), TINY.lm))
    full = np.concatenate([prefix, tail.astype(np.float32)])
    want = jvlm.score_continuation(jp, TINY, jnp.asarray(full), ids)
    got = tvlm.score_continuation(tp, PCFG, torch.from_numpy(full), ids)
    assert got[1] == want[1] == (cont == "greedy")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)


# ------------------------------------------------------ video QA entry

def test_sample_video_frames_matches_jax_for_every_length():
    for f0 in range(1, 401):
        got, want = tvlm.sample_video_frames(f0), jvlm.sample_video_frames(f0)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(f0))


@pytest.mark.parametrize("f0", [12, 33, 70])
def test_video_qa_embeds_matches_jax(models, f0):
    """12 frames: one padded segment of 8; 33 and 70: resampled to 64 frames
    (repeats at 33), 8 segments."""
    jp, tp = models["flat"]
    pixels = np.random.default_rng(f0).standard_normal((f0, 56, 56, 3)).astype(np.float32)
    ids = np.array(TEXT_BEFORE + [constants.IMAGE_TOKEN_INDEX] + TEXT_AFTER, np.int64)
    want = np.asarray(jvlm.video_qa_embeds(jp, TINY, pixels, ids))
    got = tvlm.video_qa_embeds(tp, PCFG, pixels, ids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    again = tvlm.video_qa_embeds(tp, PCFG, torch.from_numpy(pixels), ids)
    assert torch.equal(again, got)  # a tensor of frames takes the same path


def test_video_qa_embeds_refuses_uint8_frames(models):
    """uint8 frames now take the device preprocess: 13 frames of 60 x 80
    (not a multiple of the segment; JAX pads the frames, the port the
    features) within 1e-5 of JAX's spliced sequence, as numpy or a tensor;
    uint8 frames that are not (F, H, W, 3) RGB are refused."""
    jp, tp = models["flat"]
    pixels = np.random.default_rng(9).integers(0, 256, (13, 60, 80, 3), dtype=np.uint8)
    ids = np.array([1, constants.IMAGE_TOKEN_INDEX, 2])
    want = np.asarray(jvlm.video_qa_embeds(jp, TINY, pixels, ids))
    got = tvlm.video_qa_embeds(tp, PCFG, pixels, ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(tvlm.video_qa_embeds(tp, PCFG, torch.from_numpy(pixels), ids), got)
    with pytest.raises(ValueError, match="frames"):
        tvlm.video_qa_embeds(tp, PCFG, np.zeros((4, 56, 56, 4), np.uint8), ids)
