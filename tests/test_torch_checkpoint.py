"""The PyTorch port's safetensors reader (torch and numpy only) loads what
the JAX package writes, F32 and BF16, equal to the JAX package's
``load_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fish_tts_tpu.config import TINY_CONFIG
from fish_tts_tpu.models import dual_ar as jdual
from fish_tts_tpu.utils import checkpoint as jckpt
from fish_tts_tpu_torch.utils import checkpoint as tckpt


def test_safetensors_reader_matches_load_params(tmp_path):
    from fish_tts_tpu.testing import write_tiny_model_dir

    d = write_tiny_model_dir(tmp_path / "tiny")
    params = jdual.init_params(jax.random.PRNGKey(3), TINY_CONFIG, jnp.float32)
    jckpt.save_params(tmp_path / "bf16.safetensors", params, dtype="bf16")
    for f in (d / "lm.safetensors", d / "vocoder.safetensors", tmp_path / "bf16.safetensors"):
        want = jckpt.flatten_params(jckpt.load_params(f))
        got = tckpt.load_safetensors(f)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              w.view(np.int16), err_msg=k)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    tree = tckpt.load_params(d / "vocoder.safetensors")
    assert isinstance(tree["decoder"]["blocks"], list)
