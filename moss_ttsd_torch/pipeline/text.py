"""Multi-speaker script normalization.

Behavioral equivalent of reference generation_utils.py:252-338 normalize_text:
  1. no line breaks; 2. strip non-speaker [brackets] (keep content);
  3. remove decorative symbols; 4. internal punctuation -> comma (only ？/，
     families survive mid-text; the reference maps ？ to ， as well);
  5. only the final period survives (earlier 。 -> ，); 6. 哈哈+ -> (笑),
     haha -> (laughs); 7. [N] -> [SN]; 8. merge adjacent same-speaker tags.
"""

from __future__ import annotations

import re

_REMOVE_CHARS = "【】《》（）『』「」""\"-“”～~"
_INTERNAL_PUNCT = {
    "！": "，", "!": ",",
    "；": "，", ";": ",",
    "：": "，", ":": ",",
    "、": "，",
    "？": "，", "?": ",",
}


def normalize_text(text: str) -> str:
    # numeric speaker tags -> [SN]
    text = re.sub(r"\[(\d+)\]", r"[S\1]", text)
    # non-speaker brackets: drop the brackets, keep the content
    text = re.sub(r"\[(?!S\d+\])([^\]]*)\]", r"\1", text)

    segments = re.split(r"(?=\[S\d+\])", text.replace("\n", " "))
    parts = []
    for seg in segments:
        seg = seg.strip()
        if not seg:
            continue
        m = re.match(r"^(\[S\d+\])\s*(.*)", seg)
        tag, content = m.groups() if m else ("", seg)

        content = re.sub(f"[{re.escape(_REMOVE_CHARS)}]", "", content)
        content = re.sub(r"哈{2,}", "(笑)", content)
        content = re.sub(r"\b(ha(\s*ha)+)\b", "(laughs)", content,
                         flags=re.IGNORECASE)
        content = content.replace("——", "，").replace("……", "，")
        content = content.translate(str.maketrans(_INTERNAL_PUNCT))
        content = content.strip()

        if len(content) > 1:
            last = content[-1]
            if last == "，":
                last = "。"
            elif last == ",":
                last = "."
            content = content[:-1].replace("。", "，") + last

        parts.append((tag, content))

    if not parts:
        return ""

    merged = []
    cur_tag, cur_content = parts[0][0], [parts[0][1]]
    for tag, content in parts[1:]:
        if tag == cur_tag and cur_tag:
            cur_content.append(content)
        else:
            merged.append(f"{cur_tag}{''.join(cur_content)}".strip())
            cur_tag, cur_content = tag, [content]
    merged.append(f"{cur_tag}{''.join(cur_content)}".strip())

    return "".join(merged).replace("‘", "'").replace("’", "'")


def rewrite_speaker_tags(text: str) -> str:
    """[S1]/[S2] -> <speaker1>/<speaker2> (reference generation_utils.py:370)."""
    return text.replace("[S1]", "<speaker1>").replace("[S2]", "<speaker2>")
