"""Batch-1 serving engine (counterpart of vits_tpu/infer.py's EmoVITS): a
deployment directory (config.json beside a `.npz` checkpoint written by the
JAX package, or a reference `.pth`), speaker-id remaps `*.map` and
per-speaker emotion banks `<spkid>.emo` with mtime reload, the pre-sampled
noise ring, and three synthesis paths:

- `infer_fused`, the default of `infer`: text encoder, durations and the
  frame count on the device (`Synthesizer.inference_durations`, the count
  not clamped); the frame count read back to the host and compared with a
  frame budget of `VITS_TPU_FUSED_FRAMES_PER_TOKEN` (default 8) frames per
  token; then the alignment, flows and decoder on the device
  (`inference_decode`) over that count in whole frame quanta, its noise a
  slice of a device copy of the ring drawn for the budget, and the served
  samples read back. A request whose durations fill the budget is served
  again by the exact two-phase path. It decodes in float unless
  `VITS_TPU_FUSED_Q8=1` (read per call) and the int8 decoder is frozen.
  `VITS_TPU_FUSED=0` (read at construction) routes `infer` to two-phase.
  Its two launch-bound halves, the head (text encoder, durations, frame
  count) and the reversed flows, run through `serve/graphs.py::HalfGraphs`,
  one entry a text pad and one a frame pad, on every device. On CUDA, unless
  an AOT bundle serves, the entries are CUDA graphs captured when the engine
  is built and replayed; elsewhere they run their functions. The alignment
  and the decoder run as they are. The entries' static buffers serve one
  request at a time (the socket server holds a lock around the engine).
- `_infer_two_phase`: phase 1 encodes text and predicts durations on the
  device; the host turns durations into the alignment and slices the noise
  ring; phase 2 runs the flows and the decoder.
- `infer_stream`: two-phase up to the latent, then the float decoder over
  windows with a receptive-field halo, yielding each window's interior; the
  chunks concatenate to the two-phase output.

With `aot=True` (or `VITS_TPU_AOT=1`) the engine serves from the bucketed
programs that `python -m vits_tpu_torch.export --convert 1` writes beside
the checkpoint (`serve/aot.py`; CUDA graphs on the GPU): `infer` stays
two-phase, phase 1 runs the text bucket's program, phase 2 the frame
bucket's unless the int8 decoder serves, and a request past the buckets runs
eagerly. fp32 only; a directory without programs logs a warning and serves
eagerly.

With `quantize=True` the first `VITS_TPU_Q8_CALIB_REQUESTS` requests
(default 8) are served two-phase by the float decoder while their
activation max-abs values are recorded; the decoder is then quantized and,
if its waveform correlates with the float decode on the freezing request
(`VITS_TPU_Q8_MIN_CORR`, default 0.995), int8 decodes run every ResBlock2
chain through the CUDA kernel of `vits_tpu_torch.nn.rb_chain` on the GPU.

Compute dtype: float32 (the default) or bfloat16, from `compute_dtype`
("fp32"/"bf16" or the torch dtype) or `VITS_TPU_DTYPE`, as the JAX
package's engine takes it. In bf16 the folded weights are cast once, each
request's inputs and the noise slice at use, and every path above runs in
bf16: phase 1, the flows and the float decoder, and the int8 decoder, whose
calibration records the bf16 activations, whose weights are quantized from
the bf16-cast ones, whose convs dequantize to bf16 and whose ResBlock2
chains run K1's bf16 form. Durations, frame counts and the waveform come
back to the host in float32.

Entry points run on `cuda` unless `device="cpu"` is passed. Serving on the
GPU turns TF32 off for cuDNN convolutions and cuBLAS matmuls
(`torch.backends.cudnn.allow_tf32`, `torch.backends.cuda.matmul.allow_tf32`),
process-wide: in fp32, TF32 would move the calibration values and the float
decode the gate reads.

While a profiler records, a request's layers are "vits:" spans
(`utils/profiling.span`): `engine.infer` around `infer` (its args the
request's number), `engine.prep` (resolution, the host arrays and their
copies to the device), `engine.durations` (the read back of the durations,
two-phase, or of the frame count, fused), `engine.to_host` (the waveform's
read back), `engine.retry` (a fused pass served again two-phase), and the
model's own (`synth.*`; `synth.head` around a head's graph replay,
`synth.flow` around the flows'). `EmoVITS.counts` counts the requests, the
retries, the fused passes' budgeted, decoded and served frames, and the
graphs replayed and captured, always.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from vits_tpu_torch import config as config_mod
from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.models.synthesizer import Synthesizer, stream_windows
from vits_tpu_torch.ops.seq import infer_path
from vits_tpu_torch.serve.graphs import HalfGraphs
from vits_tpu_torch.utils import checkpoint as ckpt_mod
from vits_tpu_torch.utils.profiling import span
from vits_tpu_torch.utils.summary import logger

_OFF = ("0", "", "false")


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default) not in _OFF


_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def serving_dtype(compute_dtype=None) -> torch.dtype:
    """The engine's compute dtype: `compute_dtype` ("fp32", "bf16",
    torch.float32 or torch.bfloat16), else VITS_TPU_DTYPE (default fp32).
    Raises ValueError on anything else, as the JAX package's engine does."""
    if compute_dtype is None:
        name = os.environ.get("VITS_TPU_DTYPE", "fp32")
        if name not in _DTYPES:
            raise ValueError(f"VITS_TPU_DTYPE={name!r} not recognized; valid values: "
                             f"{sorted(_DTYPES)}")
        return _DTYPES[name]
    if compute_dtype in _DTYPES.values():
        return compute_dtype
    if isinstance(compute_dtype, str) and compute_dtype in _DTYPES:
        return _DTYPES[compute_dtype]
    raise ValueError(f"compute_dtype {compute_dtype!r}: the port serves fp32 or bf16")


def find_files(root_dir: str, suffix: str):
    out = []
    for root, _, files in os.walk(root_dir, followlinks=True):
        for fn in files:
            if fn.endswith(suffix):
                out.append(os.path.join(root, fn))
    return out


class EmoVITS:
    """Bucketed batch-1 TTS inference on the port: fused by default,
    two-phase, and streaming."""

    def __init__(self, checkpoint_path: Optional[str] = None, *, device=None, loglv: int = 0,
                 text_quantum: int = 32, frame_quantum: int = 64,
                 compute_dtype=None, quantize: Optional[bool] = None,
                 aot: Optional[bool] = None):
        self.device = resolve_device(device)
        self.loglv = loglv
        if aot is None:
            aot = _env_flag("VITS_TPU_AOT", "0")
        self.compute_dtype = serving_dtype(compute_dtype)
        if aot and self.compute_dtype != torch.float32:
            raise ValueError("AOT programs are exported at fp32; "
                             "use compute_dtype=fp32 with aot=True")
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if quantize is None:
            quantize = _env_flag("VITS_TPU_QUANTIZE", "0")
        self.quantize = bool(quantize)
        if checkpoint_path is None:
            checkpoint_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "..", "checkpoint", "checkpoint.npz")
        if not checkpoint_path.endswith((".npz", ".pth", ".pt")):
            raise ValueError(f"{checkpoint_path}: the port reads the JAX package's .npz "
                             "checkpoints and reference .pth/.pt ones")
        self.res_root_path = os.path.dirname(checkpoint_path)
        hps = config_mod.get_hparams_from_file(os.path.join(self.res_root_path, "config.json"))
        self.hps = hps
        self.sampling_rate = hps.data.sampling_rate
        self.hop_size = hps.data.hop_length
        self.text_channels = hps.data.text_channels
        self.inter_channels = hps.model.inter_channels
        self.num_speaker = hps.data.n_speakers
        self.noise_scale = hps.data.noise_scale
        self.text_quantum = text_quantum
        self.frame_quantum = frame_quantum
        self.max_text_len = getattr(hps.data, "max_text_len", 384)

        # speaker id remaps + emotion banks (hot-reloadable)
        self.spkid_mapping: Dict[int, int] = {}
        self.spkid_mapping_mtime: Dict[str, int] = {}
        for map_path in find_files(self.res_root_path, ".map"):
            self._load_spkid_mapping(map_path)
        self.spk_emo_embed: Dict[int, np.ndarray] = {}
        self.spk_emo_embed_mtime: Dict[str, int] = {}
        for emo_path in find_files(self.res_root_path, ".emo"):
            try:
                spkid = int(os.path.splitext(os.path.basename(emo_path))[0])
            except ValueError:
                continue
            self._load_spk_emo_embed(spkid)

        # model: the JAX package's parameter tree, weight norm folded
        if checkpoint_path.endswith(".npz"):
            tree = ckpt_mod.read_checkpoint(checkpoint_path)[0]["model"]
        else:
            from vits_tpu_torch.utils import torch_compat
            tree = torch_compat.load_torch_checkpoint(checkpoint_path,
                                                      torch_compat.params_template(hps))
        self.synth = params_from_jax(tree, Synthesizer.from_hps(hps))
        self.synth.to(self.device, self.compute_dtype).eval()

        # AOT serving: the bucketed programs `export --convert 1` writes
        # beside checkpoint.npz, run on the model's own weights. Requests past
        # the buckets take the eager path.
        self.aot = None
        if aot:
            from vits_tpu_torch.serve.aot import AOTBundle
            bundle = AOTBundle(self.res_root_path, self.synth.state_dict(), self.device)
            if bundle.text_buckets():
                self.aot = bundle
            else:
                logger.warning("aot=True but no .pt2 programs in %s; serving from the "
                               "eager path", self.res_root_path)

        # pre-sampled noise ring buffer; the fused path slices a device copy
        rng = np.random.RandomState(12345)
        self.noise = (rng.randn(self.inter_channels * 4096) * self.noise_scale).astype(np.float32)
        self._noise_dev = self._tensor(self.noise)
        self.ring_frames = self.noise.size // self.inter_channels
        if self.ring_frames < frame_quantum:
            # the fused budget is capped at whole quanta of the ring; none fits
            raise ValueError(f"frame_quantum {frame_quantum} exceeds the noise ring's "
                             f"{self.ring_frames} frames")
        self._prefer_fused = _env_flag("VITS_TPU_FUSED", "1")

        # int8 decoder: a running max-abs over the first q8_calib_requests
        # requests (served by the float decoder), frozen with a margin and
        # gated on waveform correlation with the float decode
        self.dec_q8 = None
        self.q8_corr: Optional[float] = None
        self._q8_record = None
        self._q8_seen = 0
        self.q8_calib_requests = max(1, int(os.environ.get("VITS_TPU_Q8_CALIB_REQUESTS", "8")))
        self.q8_margin = float(os.environ.get("VITS_TPU_Q8_MARGIN", "1.1"))
        self.q8_min_corr = float(os.environ.get("VITS_TPU_Q8_MIN_CORR", "0.995"))
        self.inference = self.infer
        # requests resolved (every path), fused passes served again
        # two-phase, the fused passes' frame budgets, the frames their flows
        # and decoder ran over (whole frame quanta; none for a pass served
        # again), the frames they served, the heads and flows replayed from
        # CUDA graphs and the graphs captured (at construction), the float
        # decodes through the decoder's packed body; never reset: callers
        # take the differences of snapshots
        self.counts = {"requests": 0, "retried": 0, "fused_frames_budget": 0,
                       "fused_frames_decoded": 0, "fused_frames_served": 0,
                       "graph_replays_head": 0, "graph_replays_flow": 0, "graph_captures": 0,
                       "dec_fused": 0}

        # the float decoder's packed body (`Generator.pack_fused`: bias-free
        # convs and the glue kernels), kept by the decoder, which takes it
        # for every fp32 decode without grad; bf16 keeps the eager body,
        # rounded where the JAX package rounds
        self.synth.dec.pack_fused()

        # the fused pass's launch-bound halves, one a pad (`serve/graphs.py`):
        # CUDA graphs captured here on the card, unless an AOT bundle serves
        self._graphs = HalfGraphs(self.synth, self.device, self.compute_dtype,
                                  self.text_channels, *self.graph_pads(),
                                  capture=self.device.type == "cuda" and self.aot is None)
        self.counts["graph_captures"] = self._graphs.captures

    # ---------------- resources ----------------
    def _load_spkid_mapping(self, mapfn: str):
        if not os.path.exists(mapfn):
            return
        with open(mapfn, "rt") as f:
            for line in f:
                line = line.strip()
                if not line or line[0] == "#":
                    continue
                arr = line.split()
                if len(arr) != 2 or not (arr[0].lstrip("-").isdigit()
                                         and arr[1].lstrip("-").isdigit()):
                    continue
                self.spkid_mapping[int(arr[0])] = int(arr[1])
        self.spkid_mapping_mtime[mapfn] = int(os.stat(mapfn).st_mtime)

    def _load_spk_emo_embed(self, spkid: int):
        emo_path = os.path.join(self.res_root_path, f"{spkid}.emo")
        if os.path.exists(emo_path):
            emb = np.fromfile(emo_path, dtype=np.float32).reshape(-1, 1024)
            self.spk_emo_embed[spkid] = emb
            self.spk_emo_embed_mtime[emo_path] = int(os.stat(emo_path).st_mtime)
            return emb
        return None

    def _get_spk_emo_embed(self, emo: tuple) -> np.ndarray:
        if isinstance(emo[0], (int, np.integer)):
            emb = self.spk_emo_embed.get(int(emo[0]))
            if emb is None:
                emb = self._load_spk_emo_embed(int(emo[0]))
            if emb is None:
                raise ValueError(f"no emotion bank for speaker {emo[0]}")
        elif isinstance(emo[0], np.ndarray):
            emb = emo[0].reshape(-1, 1024).astype(np.float32)
        else:
            raise ValueError("emo[0] must be int or ndarray")
        eid = -1 if len(emo) == 1 else int(emo[1])
        if eid < 0 or eid >= emb.shape[0]:
            eid = np.random.randint(0, emb.shape[0])
        return emb[eid]

    def update(self):
        """mtime-driven hot reload of maps and banks."""
        for map_path in list(self.spkid_mapping_mtime.keys()):
            if not os.path.exists(map_path):
                self.spkid_mapping_mtime.pop(map_path)
                continue
            if int(os.stat(map_path).st_mtime) != self.spkid_mapping_mtime[map_path]:
                self._load_spkid_mapping(map_path)
        for emo_path in list(self.spk_emo_embed_mtime.keys()):
            if not os.path.exists(emo_path):
                self.spk_emo_embed_mtime.pop(emo_path)
                continue
            if int(os.stat(emo_path).st_mtime) != self.spk_emo_embed_mtime[emo_path]:
                self._load_spk_emo_embed(int(os.path.splitext(os.path.basename(emo_path))[0]))

    # ---------------- phases ----------------
    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    @staticmethod
    def _quantize(n, q, cap=None):
        m = ((n + q - 1) // q) * q
        return min(m, cap) if cap else m

    def _resolve_request(self, spkid: int, text: np.ndarray, emo):
        """Speaker remap + emotion-vector resolution."""
        x_length = int(text.shape[0])
        spkid = self.spkid_mapping.get(spkid, spkid)
        if not 0 <= spkid < self.num_speaker:
            raise ValueError(f"spkid={spkid} outside [0, {self.num_speaker})")
        if isinstance(emo, np.ndarray) and emo.ndim <= 2 and emo.size == 1024:
            emo_vec = emo.reshape(-1).astype(np.float32)
        else:
            if emo is None:
                emo = (spkid, -1)
            if isinstance(emo[0], (int, np.integer)):
                first = self.spkid_mapping.get(int(emo[0]), int(emo[0])) if emo[0] != 0 else spkid
                emo = (first, -1 if len(emo) == 1 else emo[1])
            emo_vec = self._get_spk_emo_embed(emo)
        self.counts["requests"] += 1
        return spkid, emo_vec, x_length

    def _run_phase1(self, spkid, text, emo_vec, x_length, x_pad, aot_tb=None):
        with span("engine.prep"):
            x = np.zeros((1, x_pad, self.text_channels), np.float32)
            x[0, :x_length] = text[:x_pad]
            x_mask = np.zeros((1, x_pad, 1), np.float32)
            x_mask[0, :x_length] = 1.0
            dt = self.compute_dtype
            x, x_mask = self._tensor(x, dt), self._tensor(x_mask, dt)
            emo, sid = self._tensor(emo_vec[None], dt), self._tensor([spkid], torch.long)
        if aot_tb:
            return self.aot.call_p1(aot_tb, x, x_mask, emo, sid)
        return self.synth.infer_p1(x, emo, sid, x_mask=x_mask)

    def _alignment(self, w_ceil, x_length, x_pad, y_length, y_pad):
        """Host-side duration expansion + noise-ring slice, in the compute
        dtype."""
        with span("synth.align"):
            dur = np.zeros((1, x_pad), np.float32)
            dur[0, :x_length] = w_ceil
            attn = infer_path(self._tensor(dur), y_pad)
            nl = y_pad * self.inter_channels
            start = np.random.randint(max(self.noise.size - nl, 1))
            noise = np.resize(self.noise[start:start + nl], (nl,)).reshape(
                1, y_pad, self.inter_channels)
            y_mask = np.zeros((1, y_pad, 1), np.float32)
            y_mask[0, :y_length] = 1.0
            dt = self.compute_dtype
            return attn.to(dt), self._tensor(noise, dt), self._tensor(y_mask, dt)

    def _q8_observe(self, attn, m_p, s_p, g, noise, y_mask) -> bool:
        """Fold one request's activation statistics into the running record;
        freeze and gate the int8 decoder once enough requests were seen.
        Returns True once the int8 decoder serves."""
        if self.dec_q8 is not None:
            return True
        synth = self.synth
        z_cal = synth.latent(attn, m_p, s_p, g, noise, y_mask)
        record = synth.dec.calibrate(z_cal, g=g, x_mask=y_mask)
        if self._q8_record is None:
            self._q8_record = record
        else:
            self._q8_record = {k: torch.maximum(v, record[k])
                               for k, v in self._q8_record.items()}
        self._q8_seen += 1
        if self._q8_seen < self.q8_calib_requests:
            return False
        scales = {k: v * self.q8_margin for k, v in self._q8_record.items()}
        dec_q8 = synth.dec.quantize(scales)
        # one-time quality gate: the int8 decode must correlate with the
        # float decode on the freezing request
        wav_f = synth.infer_p2(attn, m_p, s_p, g, noise, y_mask).float().cpu().numpy().ravel()
        wav_q = synth.infer_p2(attn, m_p, s_p, g, noise, y_mask,
                               dec_q8=dec_q8).float().cpu().numpy().ravel()
        denom = float(np.linalg.norm(wav_f) * np.linalg.norm(wav_q))
        corr = float(wav_f @ wav_q) / denom if denom > 0 else 0.0
        self.q8_corr = corr
        if corr < self.q8_min_corr:
            logger.warning("int8 decoder failed the correlation gate (%.4f < %.4f); "
                           "serving stays on the float path", corr, self.q8_min_corr)
            self.quantize = False
            return False
        self.dec_q8 = dec_q8
        return True

    def _count_fused(self):
        """`counts["dec_fused"]`: the decoder's own count of the runs of its
        packed body (`Generator.fused_decodes`), read after a decode."""
        self.counts["dec_fused"] = self.synth.dec.fused_decodes

    def fused_frames(self, x_length: int, duration_rate: float = 1.0) -> int:
        """The fused path's frame budget for x_length tokens:
        VITS_TPU_FUSED_FRAMES_PER_TOKEN (default 8) frames a token at the
        duration rate, in whole frame quanta, at least one quantum and at most
        the ring's whole quanta. A request that fills it is served again
        two-phase; the noise start is drawn for it."""
        fpt = float(os.environ.get("VITS_TPU_FUSED_FRAMES_PER_TOKEN", "8"))
        q = self.frame_quantum
        budget = self._quantize(max(int(x_length * fpt * duration_rate), q), q)
        return min(budget, (self.ring_frames // q) * q)

    def graph_pads(self):
        """(text pads, frame pads) the fused pass can take: each text pad
        `_quantize` gives a token count up to max_text_len, and each whole
        frame quantum up to the largest budget `fused_frames` can give (the
        ring's whole quanta), since a served count lies below its budget."""
        tq, fq = self.text_quantum, self.frame_quantum
        text = sorted({min(p, self.max_text_len) for p in range(tq, self.max_text_len + tq, tq)})
        return text, list(range(fq, (self.ring_frames // fq) * fq + 1, fq))

    @torch.inference_mode()
    def infer(self, spkid: int, text: np.ndarray, emo=None, *,
              duration_rate: float = 1.0):
        """text: (N, text_channels) float32 -> (wav float32 (T,), emotion
        vector used). The fused path unless VITS_TPU_FUSED=0, while the int8
        decoder calibrates (its record needs phase 1's outputs), or while an
        AOT bundle serves (its programs are the two phases)."""
        with span("engine.infer", str(self.counts["requests"])):
            if self._prefer_fused and self.aot is None and \
                    (not self.quantize or self.dec_q8 is not None):
                return self.infer_fused(spkid, text, emo, duration_rate=duration_rate)
            return self._infer_two_phase(spkid, text, emo, duration_rate=duration_rate)

    @torch.inference_mode()
    def _infer_two_phase(self, spkid: int, text: np.ndarray, emo=None, *,
                         duration_rate: float = 1.0):
        with span("engine.prep"):
            spkid, emo_vec, x_length = self._resolve_request(spkid, text, emo)
        return self._two_phase(spkid, emo_vec, text, x_length, duration_rate)

    def _two_phase(self, spkid: int, emo_vec: np.ndarray, text: np.ndarray, x_length: int,
                   duration_rate: float):
        """Two-phase synthesis of a resolved request (speaker remapped,
        emotion vector chosen). With an AOT bundle, phase 1 runs its text
        bucket's program, and phase 2 its frame bucket's unless the int8
        decoder serves; a request past the buckets runs eagerly."""
        aot_tb = self.aot.pick_text_bucket(x_length) if self.aot else None
        x_pad = aot_tb or self._quantize(x_length, self.text_quantum, self.max_text_len)
        m_p, s_p, logw, g = self._run_phase1(spkid, text, emo_vec, x_length, x_pad, aot_tb)

        # host: durations -> alignment
        with span("engine.durations"):
            w = np.exp(logw.float().cpu().numpy())[0, :x_length, 0] * duration_rate
        w_ceil = np.ceil(w)
        y_length = max(int(w_ceil.sum()), 1)
        aot_fb = (self.aot.pick_frame_bucket(aot_tb, y_length)
                  if aot_tb and not self.quantize else None)
        y_pad = aot_fb or self._quantize(y_length, self.frame_quantum)
        attn, noise, y_mask = self._alignment(w_ceil, x_length, x_pad, y_length, y_pad)
        if self.quantize and self._q8_observe(attn, m_p, s_p, g, noise, y_mask):
            wav = self.synth.infer_p2(attn, m_p, s_p, g, noise, y_mask, dec_q8=self.dec_q8)
        elif aot_fb:
            wav = self.aot.call_p2(aot_tb, aot_fb, attn, m_p, s_p, g, noise, y_mask)
        else:
            wav = self.synth.infer_p2(attn, m_p, s_p, g, noise, y_mask)
        self._count_fused()  # the int8 gate's float decode included
        with span("engine.to_host"):
            wav = wav[0, :y_length * self.hop_size, 0].float().cpu().numpy()
        return wav, emo_vec

    @torch.inference_mode()
    def infer_fused(self, spkid: int, text: np.ndarray, emo=None, *,
                    duration_rate: float = 1.0):
        """Batch-1 synthesis on the device (`Synthesizer.inference` in its
        two halves) within the frame budget `fused_frames` gives, the prior
        noise a slice of the device copy of the ring at a start drawn on the
        host for the budget. The head (`HalfGraphs.head_at` the text pad)
        gives the frame count unclamped; it comes back to the host, and a
        count that reaches the budget is served again by the exact two-phase
        path, with the speaker and emotion vector resolved here (the JAX
        package resolves them a second time there, so a chained speaker map
        moves its fallback to another speaker). Otherwise the flows (the
        frame pad's entry) and the decoder run over that count in whole
        frame quanta, not over the budget, and only the served samples come
        back."""
        with span("engine.prep"):
            spkid, emo_vec, x_length = self._resolve_request(spkid, text, emo)
            x_pad = self._quantize(x_length, self.text_quantum, self.max_text_len)
            budget = self.fused_frames(x_length, duration_rate)
            use_q8 = self.dec_q8 is not None and _env_flag("VITS_TPU_FUSED_Q8", "0")
            C = self.inter_channels
            x = np.zeros((1, x_pad, self.text_channels), np.float32)
            x[0, :x_length] = text[:x_pad]
            start = np.random.randint(max(self.noise.size - budget * C, 1))
            dt = self.compute_dtype
            head_graph = self._graphs.head_at(x_pad)
            args = (torch.as_tensor(x, dtype=dt), x_length,
                    torch.as_tensor(emo_vec[None], dtype=dt), spkid, duration_rate)
        head = head_graph(*args)  # the frame count unclamped: compared with the budget below
        self.counts["graph_replays_head"] += head_graph.graph is not None
        with span("engine.durations"):
            y_frames = int(head.y_lengths[0])
        self.counts["fused_frames_budget"] += budget
        if y_frames >= budget:  # the budget clipped the request
            self.counts["retried"] += 1
            with span("engine.retry"):
                return self._two_phase(spkid, emo_vec, text, x_length, duration_rate)
        # the budget is whole quanta, so the pad stays within it
        y_pad = self._quantize(y_frames, self.frame_quantum)
        noise = self._noise_dev[start:start + y_pad * C].reshape(1, y_pad, C)
        flow = self._graphs.flows[y_pad]
        self.counts["graph_replays_flow"] += flow.graph is not None
        o = self.synth.inference_decode(head, y_pad, noise=noise, flow=flow,
                                        dec_q8=self.dec_q8 if use_q8 else None)[0]
        self._count_fused()
        self.counts["fused_frames_decoded"] += y_pad
        self.counts["fused_frames_served"] += y_frames
        with span("engine.to_host"):
            wav = o[0, :y_frames * self.hop_size, 0].float().cpu().numpy()
        return wav, emo_vec

    @torch.inference_mode()
    def infer_stream(self, spkid: int, text: np.ndarray, emo=None, *,
                     duration_rate: float = 1.0, chunk_frames: Optional[int] = None,
                     halo: int = 24):
        """Streaming synthesis: yields float32 waveform chunks whose
        concatenation is the two-phase output (`_infer_two_phase`, not the
        fused default, whose noise slice starts at a draw over the frame
        budget). Phase 1,
        the alignment and the latent run once; the float decoder then runs
        over windows of chunk_frames (default the frame quantum, so the noise
        slice is the two-phase one) plus `halo` frames on each side, and each
        window's interior is yielded as soon as it is decoded."""
        chunk = chunk_frames or self.frame_quantum
        with span("engine.prep"):
            spkid, emo_vec, x_length = self._resolve_request(spkid, text, emo)
        x_pad = self._quantize(x_length, self.text_quantum, self.max_text_len)
        m_p, s_p, logw, g = self._run_phase1(spkid, text, emo_vec, x_length, x_pad)

        with span("engine.durations"):
            w = np.exp(logw.float().cpu().numpy())[0, :x_length, 0] * duration_rate
        w_ceil = np.ceil(w)
        y_length = max(int(w_ceil.sum()), 1)
        y_pad = self._quantize(y_length, chunk)
        attn, noise, y_mask = self._alignment(w_ceil, x_length, x_pad, y_length, y_pad)

        z = self.synth.latent(attn, m_p, s_p, g, noise, y_mask)
        up = self.hop_size
        for s, lo, hi, keep in stream_windows(y_length, chunk, halo, y_pad):
            seg = self.synth.dec(z[:, lo:hi], g=g, x_mask=y_mask[:, lo:hi])
            self._count_fused()
            with span("engine.to_host"):
                chunk_wav = seg[0, (s - lo) * up:(s - lo + keep) * up, 0].float().cpu().numpy()
            yield chunk_wav


def main(argv=None):
    """CLI decoding of .vec feature files."""
    import argparse
    import logging
    import time
    from vits_tpu_torch.utils.audio import write_wav

    parser = argparse.ArgumentParser(description="Decode dumped features with the port's "
                                                 "TTS generator.")
    parser.add_argument("--scpfn", "--scp", type=str, required=True)
    parser.add_argument("--spkid", "--sid", default=None, type=int)
    parser.add_argument("--emotion", "--emo", default=None, type=str,
                        help="(spkid|path, eid) emotion selector")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", "--ckpt", default=None, type=str)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default=None,
                        help="compute dtype (default: VITS_TPU_DTYPE or fp32)")
    parser.add_argument("--quantize", action="store_true", default=None,
                        help="int8 decoder serving mode")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARN)
    os.makedirs(args.outdir, exist_ok=True)
    model = EmoVITS(args.checkpoint, device=args.device, loglv=args.verbose,
                    compute_dtype=args.dtype, quantize=args.quantize)

    features = {}
    with open(args.scpfn) as fid:
        for line in fid:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split("|")
            utt_id = os.path.splitext(os.path.basename(parts[0]))[0]
            spkid = args.spkid if args.spkid is not None else (
                int(parts[-1]) if len(parts) > 1 else 1)
            emo = None
            src = args.emotion if args.emotion is not None else (
                parts[1] if len(parts) > 2 else None)
            if src:
                e = src.split(":")
                if os.path.exists(e[0]):
                    e0 = np.fromfile(e[0], dtype=np.float32).reshape(-1, 1024)
                else:
                    e0 = int(e[0])
                emo = (e0, int(e[1]) if len(e) > 1 else -1)
            features[utt_id] = (spkid, emo, parts[0])

    total_rtf, idx = 0.0, 0
    for idx, (utt_id, (spkid, emo, vecfn)) in enumerate(features.items(), 1):
        start = time.time()
        text = np.fromfile(vecfn, dtype=np.float32).reshape(-1, model.text_channels)
        wav, _ = model.infer(spkid, text, emo)
        write_wav(os.path.join(args.outdir, f"{utt_id}.wav"), wav, model.sampling_rate)
        total_rtf += (time.time() - start) / (len(wav) / model.sampling_rate)
    if idx:
        logging.info("Finished generation of %d utterances (RTF = %.3f).", idx, total_rtf / idx)


if __name__ == "__main__":
    main()
