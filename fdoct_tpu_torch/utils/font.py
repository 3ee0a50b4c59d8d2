"""A fixed 5 × 7 bitmap font for the viewer's Status window.

The JAX package draws its status rows with PIL's default font
(``ImageDraw.text``, fdoct_tpu/viewer.py); the port needs no imaging
package, so it carries its own glyphs.  Each printable ASCII character
(32-126) is seven rows of five pixels, typed below as seven two-digit hex
rows, bit 4 the leftmost pixel.  Any other character (the session's status
lines hold "—" and "µ") draws :data:`BOX`, an outlined cell.  Characters
advance :data:`ADVANCE` pixels; the pixels are not PIL's, whose default font
depends on the Pillow version.
"""

from __future__ import annotations

import numpy as np

#: glyph height and width, and the advance from one character to the next
HEIGHT, WIDTH, ADVANCE = 7, 5, 6
#: rows of the glyph any character outside 32-126 draws
BOX = "1F11111111111F"

_ROWS = (
    # 32-47:  space ! " # $ % & ' ( ) * + , - . /
    "00000000000000", "04040404040004", "0A0A0A00000000", "0A0A1F0A1F0A0A",
    "040F140E051E04", "18190204081303", "0C12140815120D", "0C040800000000",
    "02040808080402", "08040202020408", "0004150E150400", "0004041F040400",
    "000000000C0408", "0000001F000000", "00000000000C0C", "00010204081000",
    # 48-63:  0-9 : ; < = > ?
    "0E11131519110E", "040C040404040E", "0E11010204081F", "1F02040201110E",
    "02060A121F0202", "1F101E0101110E", "0608101E11110E", "1F010204080808",
    "0E11110E11110E", "0E11110F01020C", "000C0C000C0C00", "000C0C000C0408",
    "02040810080402", "00001F001F0000", "08040201020408", "0E110102040004",
    # 64-79:  @ A-O
    "0E11010D15150E", "0E1111111F1111", "1E11111E11111E", "0E11101010110E",
    "1C12111111121C", "1F10101E10101F", "1F10101E101010", "0E11101711110F",
    "1111111F111111", "0E04040404040E", "0702020202120C", "11121418141211",
    "1010101010101F", "111B1515111111", "11111915131111", "0E11111111110E",
    # 80-95:  P-Z [ \ ] ^ _
    "1E11111E101010", "0E11111115120D", "1E11111E141211", "0F10100E01011E",
    "1F040404040404", "1111111111110E", "11111111110A04", "1111111515150A",
    "11110A040A1111", "1111110A040404", "1F01020408101F", "0E08080808080E",
    "00100804020100", "0E02020202020E", "040A1100000000", "0000000000001F",
    # 96-111: ` a-o
    "08040200000000", "00000E010F110F", "1010161911111E", "00000E1010110E",
    "01010D1311110F", "00000E111F100E", "0609081C080808", "000F11110F010E",
    "10101619111111", "04000C0404040E", "0200060202120C", "10101214181412",
    "0C04040404040E", "00001A15151111", "00001619111111", "00000E1111110E",
    # 112-126: p-z { | } ~
    "00001E111E1010", "00000D130F0101", "00001619101010", "00000E100E011E",
    "08081C08080906", "0000111111130D", "00001111110A04", "0000111115150A",
    "0000110A040A11", "000011110F010E", "00001F0204081F", "02040408040402",
    "04040404040404", "08040402040408", "00000815020000",
)


def _bits(rows: str) -> np.ndarray:
    vals = np.array([int(rows[i:i + 2], 16) for i in range(0, 2 * HEIGHT, 2)], np.uint8)
    return (vals[:, None] >> np.arange(WIDTH - 1, -1, -1)) & 1


#: (96, HEIGHT, ADVANCE) bool: glyphs 32-126, then the box; a blank column
#: on the right of each
GLYPHS = np.zeros((len(_ROWS) + 1, HEIGHT, ADVANCE), bool)
GLYPHS[:, :, :WIDTH] = np.stack([_bits(r) for r in _ROWS + (BOX,)]).astype(bool)


def draw_text(img_u8: np.ndarray, xy: tuple[int, int], text: str, fill: int = 255) -> np.ndarray:
    """Draw ``text`` into the 2-D uint8 ``img_u8`` in place, its top-left
    corner at ``xy`` = (x, y), clipped to the image; returns ``img_u8``."""
    x, y = xy
    codes = np.fromiter(map(ord, text), np.int64, len(text)) - 32
    codes[(codes < 0) | (codes >= len(_ROWS))] = len(_ROWS)
    mask = GLYPHS[codes].transpose(1, 0, 2).reshape(HEIGHT, -1)       # (7, n·6)
    h, w = img_u8.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + HEIGHT, h), min(x + mask.shape[1], w)
    if y1 > y0 and x1 > x0:
        region = img_u8[y0:y1, x0:x1]
        region[mask[y0 - y:y1 - y, x0 - x:x1 - x]] = fill
    return img_u8
