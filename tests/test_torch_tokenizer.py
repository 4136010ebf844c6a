"""The port's tokenizer seam against the reference's.

``ByteTokenizer``, ``encode_stop_strings`` and ``trim_stop_suffix`` give
the reference's answers on the same inputs (hypothesis over UTF-8 text
and id lists). ``HFTokenizer`` loads a tokenizer the test builds itself
in ``tmp_path`` (a byte-level BPE trained on a few sentences, wrapped as
``PreTrainedTokenizerFast`` with an EOS and a chat template, saved with
``save_pretrained``; nothing is downloaded): the port and the reference
give the same ids, EOS and rendered chat.
"""

import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_gpu_device_plugin_torch.serving import tokenizer as ttok
from k8s_gpu_device_plugin_tpu.serving import tokenizer as jtok

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them
torch.set_num_threads(1)

SENTENCES = ["the quick brown fox jumps over the lazy dog",
             "hello world, héllo wörld, 你好",
             "serving models on a card, token by token"]
CHAT = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "héllo there"}]


@settings(max_examples=60, deadline=None, database=None)
@given(st.text(max_size=40))
def test_byte_tokenizer_encode_decode_match_the_reference(text):
    port, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    assert port.encode(text) == ref.encode(text)
    assert port.encode_plain(text) == ref.encode_plain(text)
    assert port.decode(port.encode(text)) == text
    assert port.vocab_size == ref.vocab_size and port.eos_id is None


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.integers(0, 511), max_size=24))
def test_byte_tokenizer_decodes_any_ids_like_the_reference(ids):
    """Ids >= 256 decode as U+FFFD, one each; partial UTF-8 runs as the
    reference's replacement."""
    port, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    assert port.decode(ids) == ref.decode(ids)


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.text(min_size=1, max_size=6), min_size=1, max_size=4))
def test_encode_stop_strings_matches_the_reference(strings):
    port = ttok.encode_stop_strings(ttok.ByteTokenizer(), strings)
    assert port == jtok.encode_stop_strings(jtok.ByteTokenizer(), strings)


@pytest.mark.parametrize("strings,tok,needle", [
    (["x"], None, "requires a tokenizer"),
    ("x", "byte", "list of non-empty strings"),
    ([""], "byte", "list of non-empty strings"),
])
def test_encode_stop_strings_refusals_match_the_reference(strings, tok,
                                                          needle):
    for mod in (ttok, jtok):
        t = mod.ByteTokenizer() if tok else None
        with pytest.raises(ValueError, match=needle):
            mod.encode_stop_strings(t, strings, field="stop_text")


@settings(max_examples=80, deadline=None, database=None)
@given(st.lists(st.integers(0, 4), max_size=10),
       st.lists(st.lists(st.integers(0, 4), min_size=1, max_size=3),
                max_size=3))
def test_trim_stop_suffix_matches_the_reference(tokens, stop):
    assert ttok.trim_stop_suffix(tokens, stop) == \
        jtok.trim_stop_suffix(tokens, stop)


def test_trim_stop_suffix_shortest_match_wins():
    # the engine halts on "b": the generated "a" stays
    assert ttok.trim_stop_suffix([7, 1, 2], [[1, 2], [2]]) == [7, 1]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A byte-level BPE trained on SENTENCES, saved as an HF tokenizer
    directory with an EOS and a chat template."""
    import tokenizers
    import transformers

    tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(SENTENCES * 4, trainer)
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        unk_token="<unk>")
    fast.chat_template = (
        "{% for m in messages %}<s>{{ m['role'] }}: {{ m['content'] }}</s>"
        "{% endfor %}{% if add_generation_prompt %}<s>assistant:{% endif %}")
    path = tmp_path_factory.mktemp("hf_tokenizer")
    fast.save_pretrained(str(path))
    return str(path)


def test_hf_tokenizer_matches_the_reference(hf_dir):
    port, ref = ttok.load_tokenizer(hf_dir), jtok.load_tokenizer(hf_dir)
    assert isinstance(port, ttok.HFTokenizer)
    assert port.eos_id == ref.eos_id is not None
    for text in SENTENCES + ["unseen wörds 🙂"]:
        assert port.encode(text) == ref.encode(text)
        assert port.encode_plain(text) == ref.encode_plain(text)
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    assert ttok.encode_stop_strings(port, ["lazy dog"]) == \
        jtok.encode_stop_strings(ref, ["lazy dog"])


def test_hf_chat_rendering_matches_the_reference(hf_dir):
    from k8s_gpu_device_plugin_torch.serving.openai_api import (
        _render_chat as port_render,
    )
    from k8s_gpu_device_plugin_tpu.serving.openai_api import (
        _render_chat as ref_render,
    )

    port, ref = ttok.load_tokenizer(hf_dir), jtok.load_tokenizer(hf_dir)
    got = port_render(port, CHAT)
    assert got == list(ref_render(ref, CHAT))
    assert port.decode(got).endswith("assistant:")
    # without a template: the role-tagged fallback, the same ids
    byte = ttok.ByteTokenizer()
    assert port_render(byte, CHAT) == ref_render(jtok.ByteTokenizer(), CHAT)


def test_load_tokenizer_specs():
    assert ttok.load_tokenizer("") is None
    assert isinstance(ttok.load_tokenizer("byte"), ttok.ByteTokenizer)
    assert isinstance(ttok.ByteTokenizer(), ttok.TokenizerSeam)


def test_hf_tokenizer_without_transformers_names_the_package(monkeypatch,
                                                             tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        ttok.HFTokenizer(str(tmp_path))
