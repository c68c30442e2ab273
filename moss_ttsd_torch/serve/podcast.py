"""Podcast generation, port of ``moss_ttsd_tpu/serve/podcast.py``: a URL,
PDF, TXT or raw-text source -> extracted text -> a two-speaker [S1]/[S2]
dialogue script from an OpenAI-compatible chat endpoint (zh/en templates;
a fixed fallback script without one) -> one voice-cloned generation
through the port's ``TTSPipeline`` -> a wav.

``requests``, ``bs4`` and ``PyPDF2`` are imported inside the calls that
need them, so a ``.txt`` source with the fallback script runs without any
of them. Runs on the CUDA card unless ``--platform cpu``:

    python -m moss_ttsd_torch.serve.podcast --input notes.txt --tiny \\
        --platform cpu --output podcast.wav
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

# Fixed per-language prompt voices: the repo's synthesized placeholder
# voices (examples/make_examples.py) with their own transcripts. Pass
# ``voices=`` / ``base_path=`` to use real recordings.
ASSET_BASE = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                          "..", ".."))


def default_asset_base() -> str:
    """Directory containing examples/voice_s{1,2}.wav.

    In a source checkout that is the repo root (two levels above serve/).
    For an installed package, where no examples/ tree ships, the two
    placeholder voices are synthesized once into a user cache directory
    with the recipe of examples/make_examples.py, so the default podcast
    voices work in any layout."""
    if os.path.exists(os.path.join(ASSET_BASE, "examples", "voice_s1.wav")):
        return ASSET_BASE
    cache = os.path.join(os.path.expanduser("~"), ".cache", "moss_ttsd_torch",
                         "assets")
    exdir = os.path.join(cache, "examples")
    sentinel = os.path.join(exdir, ".voices_ready")
    if not os.path.exists(sentinel):
        import tempfile

        import numpy as np
        from ..utils.audio_io import write_wav
        os.makedirs(exdir, exist_ok=True)
        sr = 16000
        t = np.arange(3 * sr) / sr
        for name, f0, vib_hz, seed in (("voice_s1.wav", 130.0, 5.0, 1),
                                       ("voice_s2.wav", 210.0, 6.5, 2)):
            rng = np.random.default_rng(seed)
            vib = 1.0 + 0.01 * np.sin(2 * np.pi * vib_hz * t)
            wav = np.zeros_like(t)
            for h, amp in enumerate([1.0, 0.5, 0.33, 0.2, 0.1], start=1):
                wav += amp * np.sin(2 * np.pi * f0 * h * vib * t
                                    + rng.uniform(0, np.pi))
            env = 0.4 + 0.3 * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, 1)
            wav = wav * env / np.max(np.abs(wav)) * 0.6
            # write-then-rename so a concurrent process never reads a
            # half-written wav; the sentinel (written last) gates the whole
            # set, so readers only proceed once both voices are in place
            fd, tmp = tempfile.mkstemp(suffix=".wav", dir=exdir)
            os.close(fd)
            try:
                write_wav(tmp, wav.astype(np.float32), sr)
                os.replace(tmp, os.path.join(exdir, name))
            finally:
                # a failed write/replace must not strand tmp files in the
                # shared cache dir (the sentinel never lands, so every later
                # call would re-enter and add another orphan)
                if os.path.exists(tmp):
                    os.unlink(tmp)
        with open(sentinel, "w") as f:
            f.write("ok\n")
    return cache


DEFAULT_VOICES = {
    "zh": {"prompt_audio_speaker1": "examples/voice_s1.wav",
           "prompt_text_speaker1": "这是第一位说话人的参考音色。",
           "prompt_audio_speaker2": "examples/voice_s2.wav",
           "prompt_text_speaker2": "这是第二位说话人的参考音色。"},
    "en": {"prompt_audio_speaker1": "examples/voice_s1.wav",
           "prompt_text_speaker1": "This is the first speaker reference voice.",
           "prompt_audio_speaker2": "examples/voice_s2.wav",
           "prompt_text_speaker2": "And this is the second speaker reference "
                                   "voice."},
}

# Scriptwriting prompts. Same structural-constraint set as the reference's
# templates (podcast_generate.py:224-310) — language style, loose spoken
# sentence structure with fillers/reduplication, [S1]/[S2] turn marking with
# heavy listener backchannels, punctuation whitelist, contextual number
# verbalization, completeness + term-explanation content rules, and the
# 1500-character/word (~10 min) hard cap — phrased in our own words.
SCRIPT_PROMPT_ZH = """你是一位资深的中文播客文字编剧。请把下面的原始材料改写成两位中文播客主持人之间的自然对谈脚本，并严格满足全部要求：

一、语言风格
- 口语优先：用轻松随意的日常中文说话，不要书面腔；把材料里的书面表达改写成口语说法，但专业名词本身保持不变；
- 词汇尽量简单好懂，可以适度用一些网络热词、俗语来增加真实感；
- 整体听感要像两位熟悉的主持人在录节目聊天。

二、句式
- 句子结构松散自然，允许口语特有的重复、停顿和语气词；
- 多用叠词（比如"特别特别"、"慢慢来"）和填充词（比如"这个"、"其实"、"然后"、"就是"、"呃"）；
- 可以带一点模糊和情绪化的表达，让语气更亲切。

三、对话组织
- 两人交替发言，每个轮次用 [S1] 或 [S2] 开头标记，[S1] 和 [S2] 之间不要换行；
- 重点：当一方在讲解时，另一方要频繁插入简短的倾听反馈（比如"嗯嗯。""对对。""这样啊。""哦？""懂了。""原来如此。""还真是。""嗯，有道理。"），自然地落在对方语句的停顿处或段落交界处，而不是生硬打断。示例：[S2]我平时其实不怎么喝咖啡的，[S1]嗯嗯。[S2]一开始总觉得，呃，下午来一杯晚上就别想睡了，[S1]对对。[S2]后来发现早上喝一杯其实完全没事。这类反馈越多越好，不要吝啬；
- 节目要有开场引入、核心讨论和自然收尾，语气有起伏，不要平铺直叙；
- 硬性限制：总长度控制在十分钟朗读时长以内（不超过一千五百字），绝对不许超。

四、标点与数字
- 只允许用中文逗号、句号、问号；禁止叹号、省略号、括号、各种引号和破折号等一切其他符号；
- 所有数字都写成中文读法，例如"1000000"写成"一百万"；
- 根据上下文判断数字怎么读：带数字的英文缩写要意译（"a2b"写成"a到b"，"gpt-4o"写成"GPT四O"，"3:4"写成"三比四"）；"2021"表示年份时写"二零二一"，表示数量时写"两千零二十一"。

五、内容
- 所有信息都要基于原始材料改写，材料里的内容一条都不能丢；
- 可以加入背景补充、吐槽、对比、联想和提问来带动节奏；
- 信息密度要高，引用要交代清楚上下文，保证听众能跟上；
- 对话里不要出现"我是S1"之类的自我指称；
- 出现专业术语要顺带解释，抽象的技术点用比喻或类比讲明白。

## 原始材料
{content}

请按以上全部要求输出播客对话脚本。只能用 [S1] 和 [S2] 标记说话人，不许用任何其他标记方式。直接输出脚本本身，不要附加任何说明。"""

SCRIPT_PROMPT_EN = """You are a seasoned English podcast scriptwriter. Rewrite \
the source material below as a natural conversation between two English \
podcast hosts, strictly following every requirement:

I. Language style
- Spoken first: relaxed, casual, everyday English — no written-register \
phrasing. Convert formal wording into how people actually talk, while \
keeping technical terms themselves intact.
- Prefer simple words; a little slang or idiom is welcome when it makes the \
chat feel real.
- The whole thing should sound like two hosts who know each other recording \
an episode.

II. Sentence structure
- Loose, natural sentences; spoken artifacts like repetition, pauses and \
filler words are encouraged ("like", "actually", "so", "you know", "uh"), \
plus doubled intensifiers ("very, very", "take it slow").
- A bit of vagueness or emotional coloring is fine — it makes the hosts \
approachable.

III. Dialogue organization
- The hosts alternate turns, each turn marked with [S1] or [S2]; never put a \
newline between [S1] and [S2].
- Key requirement: while one host explains something, the other must keep \
dropping in short listener backchannels ("Uh-huh.", "Gotcha.", "For sure.", \
"Oh wow.", "Huh.", "True.", "Interesting.", "Fair enough."), placed naturally \
at pauses and transitions rather than as interruptions. Example: [S2] I never \
used to drink much coffee, honestly. [S1] Uh-huh. [S2] At first I figured, \
uh, one afternoon cup and I would be up all night, [S1] Gotcha. [S2] but a \
morning cup turned out to be completely fine. Use plenty of these — don't \
hold back.
- Give the episode an opening hook, a core discussion and a natural wrap-up, \
with rhythm and variation rather than a flat read-through.
- Hard limit: keep the total under a ten-minute read (no more than 1500 \
words). Never exceed it.

IV. Punctuation and numbers
- Only commas, periods and question marks. No exclamation marks, ellipses, \
parentheses, quotation marks of any kind, or dashes.
- Spell every number out in words, e.g. "1,000,000" becomes "one million".
- Read numbers by context: verbalize alphanumeric abbreviations ("a2b" as "a \
to b", "gpt-4o" as "GPT four O", "3:4" as "three to four"); "2021" is \
"twenty twenty-one" as a year but "two thousand twenty-one" as a quantity.

V. Content
- Everything must be rewritten from the source material, and every piece of \
information in it must be covered — nothing dropped.
- Feel free to add background, light roasting, comparisons, associations and \
questions to keep the rhythm going.
- Keep the information density high and give citations enough context for \
listeners to follow.
- The hosts must never self-identify ("I am S1" and similar is forbidden).
- Explain technical terms as they come up; unpack abstract ideas with \
analogies or metaphors so they never sound opaque.

## Source material
{content}

Convert the source material into a podcast dialogue script meeting all the \
requirements above. Mark the speakers only with [S1] and [S2] — absolutely \
no other speaker markers. Output the script directly with no extra text."""

FALLBACK_SCRIPT_ZH = ("[S1]欢迎收听本期节目。今天我们聊的材料内容非常有意思。"
                      "[S2]是的，虽然自动脚本生成暂时不可用，我们还是为大家准备了这段演示。"
                      "[S1]感谢收听，我们下期再见。")
FALLBACK_SCRIPT_EN = ("[S1]Welcome to the show. Today's material was really "
                      "interesting. [S2]Indeed — although automatic script "
                      "generation was unavailable, here is a short demo. "
                      "[S1]Thanks for listening.")


# -- source extraction -------------------------------------------------------

def extract_text_from_txt(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def extract_text_from_pdf(path: str) -> str:
    try:
        import PyPDF2
    except ImportError as e:
        raise ImportError("PyPDF2 not installed; cannot extract PDF text") from e
    out = []
    with open(path, "rb") as f:
        reader = PyPDF2.PdfReader(f)
        for page in reader.pages:
            out.append(page.extract_text() or "")
    return "\n".join(out)


def extract_web_content(url: str) -> str:
    import requests
    from bs4 import BeautifulSoup
    r = requests.get(url, timeout=30,
                     headers={"User-Agent": "Mozilla/5.0 (podcast-bot)"})
    r.raise_for_status()
    soup = BeautifulSoup(r.text, "html.parser")
    for tag in soup(["script", "style", "nav", "header", "footer"]):
        tag.decompose()
    text = soup.get_text(separator="\n")
    lines = [l.strip() for l in text.splitlines() if l.strip()]
    return "\n".join(lines)


def parse_input_content(source: str) -> str:
    """URL / .pdf / .txt / raw text -> extracted text."""
    if re.match(r"^https?://", source):
        return extract_web_content(source)
    if source.lower().endswith(".pdf") and os.path.exists(source):
        return extract_text_from_pdf(source)
    if source.lower().endswith(".txt") and os.path.exists(source):
        return extract_text_from_txt(source)
    return source


# -- script generation -------------------------------------------------------

def generate_podcast_script(content: str, language: str = "zh",
                            base_url: Optional[str] = None,
                            api_key: Optional[str] = None,
                            model: str = "gemini-2.5-pro",
                            max_content_chars: int = 50_000) -> str:
    """Ask an OpenAI-compatible chat endpoint (``base_url``, else
    ``PODCAST_LLM_BASE``; key ``api_key``, else ``PODCAST_LLM_KEY``) to
    write the dialogue script; falls back to a fixed sample script without
    an endpoint, on failure, or when the answer has no [S1] tag."""
    template = SCRIPT_PROMPT_ZH if language == "zh" else SCRIPT_PROMPT_EN
    prompt = template.format(content=content[:max_content_chars])
    base_url = base_url or os.environ.get("PODCAST_LLM_BASE")
    api_key = api_key or os.environ.get("PODCAST_LLM_KEY", "")
    if not base_url:
        print("no LLM endpoint configured (set PODCAST_LLM_BASE or pass "
              "base_url); using the canned fallback script — it IGNORES "
              "your source material")
    if base_url:
        try:
            import requests
            r = requests.post(
                f"{base_url.rstrip('/')}/chat/completions",
                json={"model": model,
                      "messages": [{"role": "user", "content": prompt}]},
                headers={"Authorization": f"Bearer {api_key}"} if api_key else {},
                timeout=300)
            r.raise_for_status()
            script = r.json()["choices"][0]["message"]["content"].strip()
            # the synthesizer consumes one continuous line
            script = script.replace("\n", "").replace("\r", "")
            if "[S1]" in script:
                return script
            print("LLM response missing [S1] tags; using fallback")
        except Exception as e:
            print(f"script generation failed ({e}); using fallback")
    return FALLBACK_SCRIPT_ZH if language == "zh" else FALLBACK_SCRIPT_EN


def detect_language(text: str) -> str:
    zh = len(re.findall(r"[一-鿿]", text))
    return "zh" if zh > len(text) * 0.1 else "en"


# -- end to end --------------------------------------------------------------

def process_input_to_audio(source: str, pipe, output_path: str,
                           language: Optional[str] = None,
                           voices: Optional[dict] = None,
                           base_path: Optional[str] = None,
                           use_normalize: bool = True, seed: int = 0,
                           llm_base_url: Optional[str] = None,
                           llm_api_key: Optional[str] = None) -> dict:
    """Long-form synthesis as ONE generation with both voices cloned, over
    ``pipe.process_batch``; writes the wav to ``output_path`` and returns
    {script, language, output, duration_s}."""
    from ..utils.audio_io import write_wav
    content = parse_input_content(source)
    language = language or detect_language(content)
    script = generate_podcast_script(content, language, llm_base_url,
                                     llm_api_key)
    voice = dict(voices or DEFAULT_VOICES[language])
    item = {"base_path": base_path or default_asset_base(),
            "text": script, **voice}
    texts_data, audio_results = pipe.process_batch(
        [item], use_normalize=use_normalize, seed=seed)
    if not audio_results or audio_results[0] is None:
        raise RuntimeError("synthesis produced no audio")
    res = audio_results[0]
    write_wav(output_path, res["audio_data"], res["sample_rate"])
    return {"script": script, "language": language, "output": output_path,
            "duration_s": res["audio_data"].shape[-1] / res["sample_rate"]}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Podcast generation (PyTorch / CUDA port)")
    p.add_argument("--input", required=True, help="URL, .pdf, .txt, or raw text")
    p.add_argument("--output", default="podcast.wav")
    p.add_argument("--language", choices=["zh", "en"], default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (smoke test); also the default "
                        "without --model_path")
    p.add_argument("--model_path", default=None)
    p.add_argument("--spt_config", default=None)
    p.add_argument("--spt_ckpt", default=None)
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA card; cpu = run on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.tiny or not args.model_path:
        from ..cli.inference import build_tiny_pipeline
        pipe = build_tiny_pipeline(device=device)
    else:
        from ..cli.inference import SPT_CHECKPOINT_PATH, SPT_CONFIG_PATH
        from ..pipeline.batch import TTSPipeline
        pipe = TTSPipeline.load(args.model_path,
                                args.spt_config or SPT_CONFIG_PATH,
                                args.spt_ckpt or SPT_CHECKPOINT_PATH,
                                device=device)
    info = process_input_to_audio(args.input, pipe, args.output,
                                  language=args.language)
    print(json.dumps({k: v for k, v in info.items() if k != "script"},
                     ensure_ascii=False))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
