"""The port's sequence parallelism on the CPU: ``parallel/sequence.py``
(the time-sharded LSTM pipeline over a single-process mesh) against the
port's one-device ``lstm_scan``, JAX's ``models.recurrent.lstm_layer`` and
JAX's own ``sequence_sharded_lstm`` on its 8-device ``time`` mesh, all
within atol 1e-6, at D ∈ {1, 2, 4, 8} positions. The CPU has one device,
so every position names it (``partition.MeshConfig`` accepts a device at
several positions); a host of cards lays the positions over its cards.

Inputs: those of ``tests/test_parallel.py``'s sequence test (seed 11,
T = 64, I = 6, H = 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.recurrent import (  # noqa: E501
    lstm_scan,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
    sequence,
)
from deeplearninginassetpricing_paperreplication_tpu.models.recurrent import (
    lstm_layer,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    sequence as jseq,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel.mesh import (
    create_mesh as jcreate_mesh,
)

CPU = torch.device("cpu")
POSITIONS = [1, 2, 4, 8]
T, I, H = 64, 6, 5


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, I)).astype(np.float32)
    k = 1.0 / np.sqrt(H)
    params = {name: rng.uniform(-k, k, shape).astype(np.float32)
              for name, shape in (("w_ih", (4 * H, I)), ("w_hh", (4 * H, H)),
                                  ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
    return x, params


def _mesh(D):
    return partition.MeshConfig(((sequence.TIME_AXIS, D),),
                                (CPU,) * D).build()


@pytest.fixture(scope="module")
def refs():
    """The port's sequence output at each D and the three references."""
    x, params = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jmesh = jcreate_mesh(axis_name="time")
    assert jmesh.devices.size == 8
    jsharded = jax.jit(lambda p, xs: jseq.sequence_sharded_lstm(p, xs, jmesh))(
        jp, jseq.shard_sequence(jnp.asarray(x), jmesh))
    return {
        "x": tx, "params": tp,
        "port": {D: sequence.sequence_sharded_lstm(tp, tx, _mesh(D))
                 for D in POSITIONS},
        "lstm_scan": lstm_scan(tp, tx)[0].numpy(),
        "jax_lstm_layer": np.asarray(lstm_layer(jp, jnp.asarray(x))),
        "jax_sequence_sharded_lstm": np.asarray(jsharded),
    }


@pytest.mark.parametrize("ref", ["lstm_scan", "jax_lstm_layer",
                                 "jax_sequence_sharded_lstm"])
@pytest.mark.parametrize("D", POSITIONS)
def test_pipeline_is_the_one_device_lstm(refs, D, ref):
    chunks = refs["port"][D]
    assert len(chunks) == D
    out = torch.cat(chunks).numpy()
    assert out.shape == (T, H)
    np.testing.assert_allclose(out, refs[ref], atol=1e-6, rtol=0)


@pytest.mark.parametrize("D", POSITIONS)
def test_shard_sequence_lays_out_chunks(refs, D):
    """D contiguous [T/D, I] chunks, each on its position's device, whose
    concatenation is x; the pipeline takes them as they are."""
    x = refs["x"]
    chunks = sequence.shard_sequence(x, _mesh(D))
    assert isinstance(chunks, tuple) and len(chunks) == D
    for d, c in enumerate(chunks):
        assert c.shape == (T // D, I) and c.device == CPU
        assert torch.equal(c, x[d * T // D:(d + 1) * T // D])
    out = sequence.sequence_sharded_lstm(refs["params"], chunks, _mesh(D))
    assert all(torch.equal(a, b) for a, b in zip(out, refs["port"][D]))
    assert all(o.shape == (T // D, H) and o.device == CPU for o in out)


def test_ragged_sequence_raises():
    """T not divisible by the axis raises, as JAX's does; so do chunks of
    the wrong count or of unequal lengths."""
    _, params = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="must divide"):
        sequence.sequence_sharded_lstm(tp, torch.zeros(13, I), _mesh(8))
    with pytest.raises(ValueError, match="must divide"):
        sequence.shard_sequence(torch.zeros(13, I), _mesh(8))
    with pytest.raises(ValueError, match="chunks"):
        sequence.sequence_sharded_lstm(tp, (torch.zeros(8, I),) * 3,
                                       _mesh(2))
    with pytest.raises(ValueError, match="one length"):
        sequence.sequence_sharded_lstm(
            tp, (torch.zeros(6, I), torch.zeros(10, I)), _mesh(2))


def test_the_mesh_must_be_one_time_axis():
    _, params = _inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = partition.MeshConfig((("batch", 1), ("time", 2)),
                                (CPU,) * 2).build()
    with pytest.raises(ValueError, match="1-D mesh"):
        sequence.sequence_sharded_lstm(tp, torch.zeros(8, I), mesh)
