"""Neural OOV grapheme-to-phoneme fallback (reference g2p/oov_onnx.rs).

Loads a Moonshine-TTS-format OOV model directory: ``onnx-config.json``
(char/phoneme vocabularies, sequence limits, special ids — schema v1) plus
``model.onnx``, an encoder-decoder transformer with fixed-width inputs
``encoder_input_ids / encoder_attention_mask / decoder_input_ids /
decoder_attention_mask`` and a ``logits`` output. ``predict_phonemes`` is
the greedy reference loop; ``predict_phonemes_beam`` is the production path
(beam width 3, matching the reference's DEFAULT_BEAM_WIDTH).

A copy of ``crane_tpu/text/oov.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

SCHEMA_VERSION = 1
DEFAULT_BEAM_WIDTH = 3
_PAD, _UNK, _BOS, _EOS = "<pad>", "<unk>", "<bos>", "<eos>"


@dataclasses.dataclass
class OovConfig:
    char_to_id: dict
    phoneme_to_id: dict
    id_to_phoneme: list
    max_seq_len: int
    max_phoneme_len: int
    char_pad_id: int
    char_unk_id: int
    phoneme_bos_id: int
    phoneme_eos_id: int
    phoneme_pad_id: int

    @classmethod
    def from_json(cls, text: str) -> "OovConfig":
        raw = json.loads(text)
        if raw.get("config_schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported OOV config schema {raw.get('config_schema_version')}"
            )
        cv, pv = raw["char_vocab"], raw["phoneme_vocab"]
        for tok in (_PAD, _UNK):
            if tok not in cv:
                raise ValueError(f"char_vocab missing {tok}")
        for tok in (_BOS, _EOS, _PAD):
            if tok not in pv:
                raise ValueError(f"phoneme_vocab missing {tok}")
        id_to_ph = [""] * len(pv)
        for ph, i in pv.items():
            if not 0 <= i < len(pv) or id_to_ph[i]:
                raise ValueError("phoneme_vocab ids must be a contiguous 0..N range")
            id_to_ph[i] = ph
        char_to_id = {}
        for k, v in cv.items():
            if k in (_PAD, _UNK, _BOS, _EOS):
                continue
            if len(k) != 1:
                raise ValueError(f"char_vocab key {k!r} is not one character")
            char_to_id[k] = v
        return cls(
            char_to_id=char_to_id, phoneme_to_id=pv, id_to_phoneme=id_to_ph,
            max_seq_len=int(raw["train_config"]["max_seq_len"]),
            max_phoneme_len=int(raw["oov_index"]["max_phoneme_len"]),
            char_pad_id=cv[_PAD], char_unk_id=cv[_UNK],
            phoneme_bos_id=pv[_BOS], phoneme_eos_id=pv[_EOS],
            phoneme_pad_id=pv[_PAD],
        )

    def tokenize(self, word: str) -> list:
        ids = [self.char_to_id.get(c, self.char_unk_id) for c in word]
        return ids[: self.max_seq_len]


class OovModel:
    def __init__(self, config: OovConfig, session):
        self.config = config
        self.session = session

    @classmethod
    def from_dir(cls, model_dir: str) -> "OovModel":
        from crane_tpu_torch.onnx import Session, read_file

        with open(os.path.join(model_dir, "onnx-config.json")) as f:
            cfg = OovConfig.from_json(f.read())
        sess = Session(read_file(os.path.join(model_dir, "model.onnx")))
        return cls(cfg, sess)

    # -- inference -----------------------------------------------------------
    def _enc_feeds(self, words: list) -> tuple:
        c = self.config
        B = len(words)
        enc = np.full((B, c.max_seq_len), c.char_pad_id, np.int64)
        mask = np.zeros((B, c.max_seq_len), np.int64)
        for b, w in enumerate(words):
            ids = c.tokenize(w)
            enc[b, : len(ids)] = ids
            mask[b, : len(ids)] = 1
        return enc, mask

    def _step_logits(self, enc, enc_mask, dec, dec_mask, step):
        out = self.session.run({
            "encoder_input_ids": enc,
            "encoder_attention_mask": enc_mask,
            "decoder_input_ids": dec,
            "decoder_attention_mask": dec_mask,
        })
        logits = out.get("logits", next(iter(out.values())))
        return np.asarray(logits, np.float32)[:, step, :]

    def predict_phonemes(self, word: str) -> list:
        """Greedy decode (the sequential correctness oracle)."""
        c = self.config
        enc, enc_mask = self._enc_feeds([word])
        dec = np.full((1, c.max_phoneme_len), c.phoneme_pad_id, np.int64)
        dec_mask = np.zeros((1, c.max_phoneme_len), np.int64)
        dec[0, 0] = c.phoneme_bos_id
        dec_mask[0, 0] = 1
        out = []
        for t in range(c.max_phoneme_len - 1):
            logits = self._step_logits(enc, enc_mask, dec, dec_mask, t)[0]
            tok = int(np.argmax(logits))
            if tok == c.phoneme_eos_id:
                break
            out.append(tok)
            dec[0, t + 1] = tok
            dec_mask[0, t + 1] = 1
        return [c.id_to_phoneme[t] for t in out
                if t != c.phoneme_pad_id and 0 <= t < len(c.id_to_phoneme)]

    def predict_phonemes_beam(
        self, word: str, beam_width: int = DEFAULT_BEAM_WIDTH
    ) -> list:
        """Beam search (the production path, oov_onnx.rs:484-650)."""
        c = self.config
        enc1, mask1 = self._enc_feeds([word])
        beams = [([], 0.0, False)]  # (tokens, logprob, done)
        for t in range(c.max_phoneme_len - 1):
            live = [b for b in beams if not b[2]]
            if not live:
                break
            B = len(live)
            enc = np.repeat(enc1, B, axis=0)
            enc_mask = np.repeat(mask1, B, axis=0)
            dec = np.full((B, c.max_phoneme_len), c.phoneme_pad_id, np.int64)
            dec_mask = np.zeros((B, c.max_phoneme_len), np.int64)
            for b, (toks, _, _) in enumerate(live):
                seq = [c.phoneme_bos_id] + toks
                dec[b, : len(seq)] = seq
                dec_mask[b, : len(seq)] = 1
            logits = self._step_logits(enc, enc_mask, dec, dec_mask, t)
            logp = logits - _logsumexp(logits)
            cands = [b for b in beams if b[2]]  # finished beams carry over
            for b, (toks, score, _) in enumerate(live):
                top = np.argsort(logp[b])[::-1][:beam_width]
                for tok in top:
                    tok = int(tok)
                    if tok == c.phoneme_eos_id:
                        cands.append((toks, score + float(logp[b, tok]), True))
                    else:
                        cands.append(
                            (toks + [tok], score + float(logp[b, tok]), False)
                        )
            # length-normalized score, like the reference's beam ranking
            cands.sort(key=lambda x: x[1] / max(len(x[0]), 1), reverse=True)
            beams = cands[:beam_width]
        best = max(beams, key=lambda x: x[1] / max(len(x[0]), 1))
        return [c.id_to_phoneme[t] for t in best[0]]

    def phonemize_word(self, word: str) -> str:
        return "".join(self.predict_phonemes_beam(word))


def _logsumexp(x, axis=-1):
    m = x.max(axis=axis, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))
