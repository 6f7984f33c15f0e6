"""JPEG marker constants (ITU-T T.81 Table B.1; cf. src/gpujpeg_marker.h)."""

SOF0 = 0xC0   # baseline DCT
SOF1 = 0xC1   # extended sequential
SOF2 = 0xC2   # progressive (rejected)
SOF3 = 0xC3   # lossless (rejected)
SOF5, SOF6, SOF7 = 0xC5, 0xC6, 0xC7
SOF9, SOF10, SOF11 = 0xC9, 0xCA, 0xCB
SOF13, SOF14, SOF15 = 0xCD, 0xCE, 0xCF
DHT = 0xC4
DAC = 0xCC    # arithmetic conditioning (rejected)
RST0 = 0xD0   # RST0..RST7 = 0xD0..0xD7
SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
DHP = 0xDE
EXP = 0xDF
APP0 = 0xE0
APP1 = 0xE1
APP8 = 0xE8
APP13 = 0xED
APP14 = 0xEE
COM = 0xFE

SEGMENT_INFO = APP13  # GPUJPEG custom segment-index header (gpujpeg_marker.h:108)

# SPIFF constants (gpujpeg_marker.h:110-116)
APP14_ADOBE_MARKER_LEN = 14
SPIFF_VERSION = 0x100
SPIFF_COMPRESSION_JPEG = 5
SPIFF_ENTRY_TAG_EOD = 0x1
SPIFF_ENTRY_TAG_ORIENTATION = 0x4
SPIFF_ENTRY_TAG_EOD_LENGTH = 8
SPIFF_MARKER_LEN = 32

MAX_HEADER_SIZE = 65536 - 100  # GPUJPEG_MAX_HEADER_SIZE (common_internal.h:91)


def is_rst(marker: int) -> bool:
    return RST0 <= marker <= RST0 + 7
