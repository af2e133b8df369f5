"""Turkish stopword list — verbatim from the paper's Tablo 4.

"Çalışmada kullanılan ve Türkçe'de cümlelere anlam katmayan
kelimelerin listesi."
"""

TURKISH_STOPWORDS = frozenset("""
acaba altı altmış ama bana bazı belki ben benden beni benim beş bi bin bir
biri birkaç birkez birşey birşeyi biz bizden bizi bizim bu buna bunda bundan
bunu bunun çok çünkü da daha dahi de defa diye doksan dokuz dört elli en gibi
hem hep hepsi her hiç için iki ile ise katrilyon kez kırk ki kim kimden kime
kimi mı milyar milyon mu mü nasıl ne neden nerde nerede nereye niçin niye on
ona ondan onlar onlardan onların onlari onu otuz sanki sekiz seksen sen
senden seni senin siz sizden sizi sizin şey şeyden şeyi şeyler şu şuna şunda
şundan şunu trilyon tüm üç ve veya ya yani yedi yetmiş yirmi yüz
""".split())


def is_stopword(token: str) -> bool:
    return token in TURKISH_STOPWORDS
