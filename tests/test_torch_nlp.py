"""The FedNLP task family's modules on the port against their JAX twins.

* The four generators (sequence classification, tagging, span extraction,
  seq2seq) and ``data.load``'s ``seqcls``, ``seqtag``, ``span``, ``s2s``
  and ``taglr`` splits, with the s2s hetero partition (bucketed by mean
  target token): bit for bit (numpy on both sides).
* ``try_load_real``: an empty cache directory gives the same synthetic split
  as none for every NLP name (the JAX package has no parser for them, or its
  parser finds no files); ``load_nuswide`` on the golden fixture equals the
  JAX parser's arrays exactly; mnist, whose parser is ported now, gives None
  from an empty cache and the JAX parser's arrays from the golden one.
* The three losses (``bce``, ``span``, ``s2s``) on random logits and labels
  with -1 targets, all -1 rows and all-padding masks: mean, total and count
  within 1e-6 (relative and absolute).
* The three encoders and the seq2seq TransformerLM (L 24, the port's
  attention as the kernels' plain versions, JAX's as its XLA reference) at
  their hub widths, from a tree of the flax model's shapes filled from numpy
  (``test_torch_packed._filled_init``), transplanted: logits within 2e-5, and
  ``FlatLayout``'s row order equal to ``ravel_pytree``'s.
* The task evals of ``ModelTrainerTAGPred``, ``ModelTrainerSpan`` and
  ``ModelTrainerS2S`` (and the server aggregator that evaluates through
  them) on the same weights and test split: every metric within 1e-5.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu_torch.ml.engine.train import init_variables, load_variables
from fedml_tpu_torch.models import convert
from test_torch_packed import _filled_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "agnews", "partition_method": "hetero", "partition_alpha": 0.5,
                  "synthetic_train_size": 96},
    "model_args": {"model": "transformer_cls"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 1, "epochs": 1,
                   "batch_size": 16, "client_optimizer": "sgd", "learning_rate": 0.1},
    "validation_args": {"frequency_of_the_test": 1},
    "device_args": {"device_type": "cpu"},
    "comm_args": {"backend": "sp"},
}
# the names of the family (and nuswide, tag prediction's other dataset)
NLP_DATASETS = ("agnews", "sst_2", "20news", "onto_tagging", "wikiner", "squad_span",
                "synthetic_s2s", "cornell_movie_dialogue", "stackoverflow_lr", "nuswide")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(dataset, model="lr", **data):
    config = copy.deepcopy(CONFIG)
    config["data_args"].update(dataset=dataset, **data)
    config["model_args"]["model"] = model
    return config


def _both(config):
    return (fedml_tpu.Arguments.from_dict(copy.deepcopy(config)).validate(),
            fedml_tpu_torch.Arguments.from_dict(copy.deepcopy(config)).validate())


# -- data ------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("make_sequence_classification", (40, 4, 16, 200)),
    ("make_sequence_tagging", (40, 8, 16, 200)),
    ("make_span_extraction", (40, 32, 200)),
    ("make_seq2seq", (40, 12, 12, 64)),
])
def test_generator_is_bit_identical(name, args):
    from fedml_tpu.data import synthetic as jsynthetic
    from fedml_tpu_torch.data import synthetic

    for seed in (0, 7):
        got = getattr(synthetic, name)(*args, seed=seed)
        want = getattr(jsynthetic, name)(*args, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("dataset,method", [
    ("agnews", "hetero"), ("onto_tagging", "hetero"), ("squad_span", "hetero"),
    ("synthetic_s2s", "hetero"), ("synthetic_s2s", "homo"), ("stackoverflow_lr", "hetero"),
    ("nuswide", "hetero"),
])
def test_load_is_bit_identical(dataset, method):
    j, t = _both(_config(dataset, partition_method=method))
    ds_j, classes_j = fedml_tpu.data.data_loader.load(j)
    ds_t, classes_t = fedml_tpu_torch.data.data_loader.load(t)
    assert classes_t == classes_j
    assert ds_t[0] == ds_j[0] and ds_t[1] == ds_j[1] and ds_t[7] == ds_j[7]
    for split in (2, 3):  # global train / test (x, y)
        for a, b in zip(ds_t[split], ds_j[split]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ds_t[4] == ds_j[4]  # per-client sample counts: the partition
    for i in range(4):
        for local in (5, 6):  # per-client train / test shards
            for a, b in zip(ds_t[local][i], ds_j[local][i]):
                assert np.array_equal(a, b), (local, i)
    if dataset == "synthetic_s2s" and method == "hetero":
        assert len(set(ds_t[4].values())) > 1  # the mean-target-token buckets skew


@pytest.mark.parametrize("dataset", NLP_DATASETS)
def test_empty_cache_dir_falls_back_to_the_synthetic_split(dataset, tmp_path):
    from fedml_tpu_torch.data.data_loader import load_centralized

    _, bare = _both(_config(dataset, synthetic_train_size=20))
    _, cached = _both(_config(dataset, synthetic_train_size=20, data_cache_dir=str(tmp_path)))
    want, got = load_centralized(bare), load_centralized(cached)
    assert cached.dataset_is_synthetic
    for key in ("x_train", "y_train", "x_test", "y_test"):
        assert np.array_equal(got[key], want[key]), key


def test_unported_parser_still_raises_with_item_3(tmp_path):
    """Every parser is ported now: a cache without mnist's files gives None
    (synthetic data), as the JAX package's does, and one with them the JAX
    parser's arrays."""
    from fedml_tpu.data import loaders as jloaders
    from fedml_tpu_torch.data import loaders

    assert loaders.try_load_real("mnist", str(tmp_path)) is None
    assert jloaders.try_load_real("mnist", str(tmp_path)) is None
    root = os.path.join(REPO, "tests", "fixtures", "golden")
    for a, b in zip(loaders.try_load_real("mnist", root), jloaders.try_load_real("mnist", root)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_nuswide_parser_matches_jax():
    from fedml_tpu.data import loaders as jloaders
    from fedml_tpu_torch.data import loaders

    root = os.path.join(REPO, "tests", "fixtures", "golden", "nuswide")
    want = jloaders.load_nuswide(root)
    for got in (loaders.load_nuswide(root), loaders.try_load_real("nuswide", root),
                loaders.try_load_real("nus_wide", root)):
        assert got is not None and len(got) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[1].shape == (6, 2)  # two concepts, multi-hot


# -- losses ------------------------------------------------------------------------


def _loss_inputs(kind, rng):
    B = 6
    if kind == "bce":
        return rng.randn(B, 5) * 3, (rng.rand(B, 5) < 0.3).astype(np.float32)
    if kind == "span":
        return rng.randn(B, 10, 2) * 3, rng.randint(0, 10, (B, 2)).astype(np.int32)
    labels = rng.randint(0, 16, (B, 8)).astype(np.int32)
    labels[:, :3] = -1  # the source prefix
    labels[2] = -1  # a row with no target
    return rng.randn(B, 8, 16) * 3, labels


@pytest.mark.parametrize("mask", ["mixed", "all_padding"])
@pytest.mark.parametrize("kind", ["bce", "span", "s2s"])
def test_loss_matches_jax(kind, mask):
    from fedml_tpu.ml.engine import train as jtrain
    from fedml_tpu_torch.ml.engine import train

    logits, labels = _loss_inputs(kind, np.random.RandomState(3))
    logits = logits.astype(np.float32)
    m = (np.array([1, 1, 0, 1, 0, 1], np.float32) if mask == "mixed"
         else np.zeros(6, np.float32))
    got_mean, (got_total, got_count) = train.LOSS_FNS[kind](
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(m))
    want_mean, (want_total, want_count) = jtrain.LOSS_FNS[kind](logits, labels, m)
    for got, want in ((got_mean, want_mean), (got_total, want_total),
                      (got_count, want_count)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if mask == "all_padding":
        assert got_count.item() == 1.0 and got_total.item() == 0.0


# -- models ------------------------------------------------------------------------


_MODELS = {}


def _models(dataset, model):
    """(JAX module, flax variables, port module on the CPU with them loaded),
    built once a module."""
    if (dataset, model) not in _MODELS:
        _MODELS[dataset, model] = _build_models(dataset, model)
    return _MODELS[dataset, model]


def _build_models(dataset, model):
    j, t = _both(_config(dataset, model))
    classes = fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]["classes"]
    jmodel = fedml_tpu.models.hub.create(j, classes)
    tmodel = fedml_tpu_torch.models.hub.create(t, classes)
    length = fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]["shape"]
    sample = np.zeros((1,) + tuple(length), np.int32 if model != "lr" else np.float32)
    jvars = _filled_init(jmodel, sample)
    cpu = torch.device("cpu")
    init_variables(tmodel, cpu)
    tvars = convert.variables_from_flax(jvars, tmodel, cpu)
    load_variables(tmodel, tvars)
    return jmodel, jvars, tmodel, tvars


@pytest.mark.parametrize("dataset,model,cls", [
    ("agnews", "transformer_cls", "TransformerClassifier"),
    ("onto_tagging", "transformer_tagger", "TransformerTagger"),
    ("squad_span", "transformer_span", "TransformerSpanExtractor"),
    ("synthetic_s2s", "transformer_s2s", "TransformerLM"),
])
def test_forward_matches_jax(dataset, model, cls):
    jmodel, jvars, tmodel, tvars = _models(dataset, model)
    assert type(tmodel).__name__ == cls
    spec = fedml_tpu_torch.data.data_loader.DATASET_SPECS[dataset]
    x = np.random.RandomState(1).randint(0, spec["vocab"], (4,) + tuple(spec["shape"]))
    x = x.astype(np.int32)
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(jvars, x))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # the round's client rows: the ravel_pytree order, column for column
    flat = convert.FlatLayout.of(tvars).ravel(tvars).numpy()
    assert np.array_equal(flat, np.asarray(ravel_pytree(jvars["params"])[0]))


# -- the task evals ------------------------------------------------------------------


@pytest.mark.parametrize("dataset,model,trainer", [
    ("stackoverflow_lr", "lr", "ModelTrainerTAGPred"),
    ("squad_span", "transformer_span", "ModelTrainerSpan"),
    ("synthetic_s2s", "transformer_s2s", "ModelTrainerS2S"),
])
def test_task_eval_matches_jax(dataset, model, trainer):
    from fedml_tpu.ml.trainer.trainer_creator import create_model_trainer as jcreate
    from fedml_tpu_torch.ml.aggregator.aggregator_creator import create_server_aggregator
    from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer

    jmodel, jvars, tmodel, tvars = _models(dataset, model)
    j, t = _both(_config(dataset, model, synthetic_train_size=160))
    ds, _ = fedml_tpu_torch.data.data_loader.load(t)
    test_data = ds[3]
    jtrainer, ttrainer = jcreate(jmodel, j), create_model_trainer(tmodel, t)
    assert type(ttrainer).__name__ == trainer == type(jtrainer).__name__
    jtrainer.set_model_params(jvars)
    ttrainer.set_model_params(tvars)
    want, got = jtrainer.test(test_data, None, j), ttrainer.test(test_data, None, t)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)
    aggregator = create_server_aggregator(tmodel, t)
    aggregator.set_model_params(tvars)
    assert aggregator.test(test_data, None, t) == got
